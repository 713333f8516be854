"""HTTP/1.1 client channel (a copy of ``brpc_tpu/rpc/http.py``).

The native core frames complete HTTP messages (chunked bodies
included) on client connections as it does on a server's, so the client
here is protocol logic only: request serialization, keep-alive
connection reuse, response parsing, and the JSON RESTful bridge
(:meth:`HttpChannel.call`: any server's ``/Service/Method`` with a JSON
body).

For progressive responses (a server's ``ProgressiveAttachment`` push,
such as ``/serving/generate``) :meth:`HttpChannel.request_stream` uses
a dedicated connection in raw mode (``MSG_RAW``) and de-chunks
incrementally, delivering each piece of data as it arrives.
"""
from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from .. import errors
from ..butil.containers import CaseIgnoredDict
from .transport import MSG_RAW, Transport


@dataclass
class HttpResponse:
    status: int = 0
    reason: str = ""
    version: str = "HTTP/1.1"
    # case-insensitive lookup, original casing preserved on iteration
    headers: CaseIgnoredDict = field(default_factory=CaseIgnoredDict)
    body: bytes = b""

    def json(self):
        return json.loads(self.body)

    @property
    def ok(self) -> bool:
        return 200 <= self.status < 300


def _dechunk(data: bytes) -> bytes:
    out = []
    off = 0
    while True:
        nl = data.find(b"\r\n", off)
        if nl < 0:
            raise ValueError("truncated chunked body")
        size_tok = data[off:nl].split(b";", 1)[0]
        size = int(size_tok, 16)
        off = nl + 2
        if size == 0:
            break
        out.append(data[off : off + size])
        off += size + 2
    return b"".join(out)


def _parse_head(head: bytes) -> HttpResponse:
    lines = head.split(b"\r\n")
    parts = lines[0].decode("latin1").split(" ", 2)
    r = HttpResponse()
    r.version = parts[0]
    r.status = int(parts[1]) if len(parts) > 1 else 0
    r.reason = parts[2] if len(parts) > 2 else ""
    for ln in lines[1:]:
        if not ln:
            continue
        k, _, v = ln.decode("latin1").partition(":")
        r.headers[k.strip()] = v.strip()
    return r


def parse_http_response(raw: bytes) -> HttpResponse:
    head, _, body = raw.partition(b"\r\n\r\n")
    r = _parse_head(head)
    if r.headers.get("transfer-encoding", "").lower().find("chunked") >= 0:
        r.body = _dechunk(body)
    else:
        r.body = body
    return r


def build_request(method: str, path: str, headers: dict | None,
                  body: bytes, host: str) -> bytes:
    hdr = [f"{method} {path} HTTP/1.1", f"Host: {host}"]
    hs = {k.lower(): (k, v) for k, v in (headers or {}).items()}
    if body and "content-length" not in hs:
        hs["content-length"] = ("Content-Length", str(len(body)))
    if "connection" not in hs:
        hs["connection"] = ("Connection", "keep-alive")
    for _, (k, v) in hs.items():
        hdr.append(f"{k}: {v}")
    hdr.append("\r\n")
    return "\r\n".join(hdr).encode("latin1") + body


class HttpChannel:
    """Keep-alive HTTP/1.1 client over the port's native socket core.

    One multiplexed connection per channel; requests are serialized (HTTP/1.1
    without pipelining — responses come back FIFO and the native executor
    may reorder message callbacks, so one in-flight request at a time).
    Reconnects transparently after peer close/failure.
    """

    def __init__(self, address: str, timeout_ms: int = 2000):
        if address.startswith("http://"):
            address = address[len("http://"):].rstrip("/")
        host, _, port = address.partition(":")
        self.host = host
        self.port = int(port) if port else 80
        self.timeout_s = timeout_ms / 1000.0
        self._sid: Optional[int] = None
        self._mu = threading.Lock()          # serializes requests
        self._resp_event = threading.Event()
        self._resp_raw: Optional[bytes] = None
        # Responses carry no ids in HTTP/1.1; correlate by socket.  A late
        # response or failure from a connection we already abandoned (timed
        # out + closed) must not complete the NEXT request.
        self._expect_sid: Optional[int] = None

    # ---- connection management ----

    def _on_message(self, sid, kind, meta, body) -> None:
        if sid != self._expect_sid:
            return  # stale response from an abandoned connection
        self._resp_raw = body.to_bytes()
        self._resp_event.set()

    def _on_failed(self, sid, err) -> None:
        if self._sid == sid:
            self._sid = None
        if sid == self._expect_sid:
            # unblock the waiter on this connection with an error
            self._resp_event.set()

    def _ensure_conn(self) -> int:
        if self._sid is not None and Transport.instance().alive(self._sid):
            return self._sid
        self._sid = Transport.instance().connect(
            self.host, self.port, self._on_message, self._on_failed)
        return self._sid

    def close(self) -> None:
        if self._sid is not None:
            Transport.instance().close(self._sid)
            self._sid = None

    # ---- requests ----

    def request(self, method: str, path: str, body: bytes | str = b"",
                headers: dict | None = None,
                timeout_s: float | None = None) -> HttpResponse:
        if isinstance(body, str):
            body = body.encode()
        deadline = timeout_s if timeout_s is not None else self.timeout_s
        if method.upper() == "HEAD":
            # HEAD responses carry entity headers (incl. Content-Length)
            # with NO body — the native keep-alive parser would wait for a
            # body that never comes, so use a one-shot raw-mode read.
            return self._head_request(path, headers, deadline)
        raw_req = build_request(method, path, headers, body,
                                f"{self.host}:{self.port}")
        with self._mu:
            try:
                for attempt in range(2):   # one transparent reconnect
                    sid = self._ensure_conn()
                    self._resp_event.clear()
                    self._resp_raw = None
                    self._expect_sid = sid
                    if Transport.instance().write_raw(sid, raw_req) != 0:
                        self._sid = None
                        continue
                    if not self._resp_event.wait(deadline):
                        # timed out: the connection state is unknown, drop it
                        self._expect_sid = None
                        Transport.instance().close(sid)
                        self._sid = None
                        raise errors.RpcError(
                            errors.ERPCTIMEDOUT,
                            f"HTTP {method} {path} timed out")
                    if self._resp_raw is None:
                        # connection failed under us; retry on a fresh one
                        continue
                    r = parse_http_response(self._resp_raw)
                    h = r.headers
                    if ("content-length" not in h
                            and "chunked" not in
                            h.get("transfer-encoding", "").lower()
                            and r.status not in (204, 304)
                            and not (100 <= r.status < 200)):
                        # No framing headers and a status that defaults to
                        # having a body: the body is close-delimited (RFC
                        # 7230 §3.3.3) and the native parser framed only
                        # the headers — fail loudly instead of returning
                        # an empty body.  request_stream() handles these
                        # via raw-mode EOF.  Drop the connection: its
                        # pending body bytes would otherwise poison the
                        # next request on the cached socket.
                        Transport.instance().close(sid)
                        if self._sid == sid:
                            self._sid = None
                        raise errors.RpcError(
                            errors.ERESPONSE,
                            "close-delimited HTTP body unsupported by "
                            "request(); use request_stream()")
                    return r
            finally:
                self._expect_sid = None
        raise errors.RpcError(errors.EFAILEDSOCKET,
                              f"HTTP connection to {self.host}:{self.port} "
                              "failed")

    def _head_request(self, path: str, headers: dict | None,
                      deadline: float) -> HttpResponse:
        reader = self.request_stream("HEAD", path, on_data=None,
                                     headers=headers)
        if not reader.wait(deadline):
            reader.cancel()
            raise errors.RpcError(errors.ERPCTIMEDOUT,
                                  f"HTTP HEAD {path} timed out")
        if reader.error is not None or reader.response is None:
            raise errors.RpcError(errors.ERESPONSE,
                                  f"HEAD failed: {reader.error}")
        return reader.response

    def get(self, path: str, **kw) -> HttpResponse:
        return self.request("GET", path, **kw)

    def post(self, path: str, body: bytes | str = b"", **kw) -> HttpResponse:
        return self.request("POST", path, body=body, **kw)

    # ---- the RESTful RPC bridge ----

    def call(self, service: str, method: str, payload,
             timeout_s: float | None = None):
        """POST /Service/Method with a JSON body against a server;
        returns the decoded JSON response or raises RpcError with the
        server-reported code."""
        r = self.post(f"/{service}/{method}", json.dumps(payload),
                      headers={"Content-Type": "application/json"},
                      timeout_s=timeout_s)
        if not r.ok:
            try:
                err = r.json()
                raise errors.RpcError(int(err.get("error", errors.EINTERNAL)),
                                      err.get("text", ""))
            except (ValueError, KeyError):
                raise errors.RpcError(errors.EINTERNAL,
                                      f"HTTP {r.status}: {r.body[:200]!r}")
        return r.json() if r.body else None

    # ---- streaming (the progressive attachment's reader) ----

    def request_stream(self, method: str, path: str,
                       on_data: Callable[[bytes], None],
                       on_end: Callable[[], None] | None = None,
                       headers: dict | None = None,
                       body: bytes = b"") -> "HttpStreamReader":
        """Issue a request on a DEDICATED raw-mode connection and deliver the
        response body incrementally (chunk by chunk for chunked transfer)."""
        reader = HttpStreamReader(on_data, on_end,
                                  head_mode=method.upper() == "HEAD")
        sid = Transport.instance().connect(
            self.host, self.port, reader._on_raw, reader._on_failed)
        Transport.instance().set_protocol(sid, MSG_RAW)
        reader._sid = sid
        raw_req = build_request(method, path, headers, body,
                                f"{self.host}:{self.port}")
        Transport.instance().write_raw(sid, raw_req)
        return reader


class HttpStreamReader:
    """Incremental HTTP response reader over a raw-mode socket: parses the
    status line + headers, then delivers body data as it arrives (de-chunked
    when the transfer is chunked)."""

    def __init__(self, on_data, on_end, head_mode: bool = False):
        self._on_data = on_data
        self._on_end = on_end
        self._head_mode = head_mode
        self._sid: Optional[int] = None
        self._buf = b""
        self._state = "headers"     # headers | chunked | length | eof_body
        self._remaining = 0         # bytes left in current chunk / body
        self._done = threading.Event()
        self.response: Optional[HttpResponse] = None
        # Set when the stream ended abnormally (malformed framing); wait()
        # still returns, callers must check .error for truncation.
        self.error: Optional[str] = None

    def wait(self, timeout_s: float | None = None) -> bool:
        return self._done.wait(timeout_s)

    def cancel(self) -> None:
        if self._sid is not None:
            Transport.instance().close(self._sid)

    # ---- internal ----

    def _finish(self) -> None:
        if not self._done.is_set():
            self._done.set()
            if self._on_end is not None:
                self._on_end()
            if self._sid is not None:
                Transport.instance().close(self._sid)

    def _on_failed(self, sid, err) -> None:
        # EOF delimits the body in eof_body mode; anywhere else a drop
        # before completion is a truncation the caller must see.
        if self._state == "eof_body":
            if self._buf:
                self._emit(self._buf)
                self._buf = b""
        elif not self._done.is_set():
            self.error = f"connection dropped mid-{self._state} (err={err})"
        self._finish()

    def _emit(self, data: bytes) -> None:
        if data and self._on_data is not None:
            self._on_data(data)

    def _on_raw(self, sid, kind, meta, body) -> None:
        self._buf += body.to_bytes()
        try:
            self._pump()
        except Exception as e:
            self.error = f"{type(e).__name__}: {e}"
            self._finish()

    def _pump(self) -> None:
        if self._state == "headers":
            pos = self._buf.find(b"\r\n\r\n")
            if pos < 0:
                return
            head = self._buf[: pos + 4]
            self._buf = self._buf[pos + 4:]
            self.response = _parse_head(head)
            h = self.response.headers
            if self._head_mode or self.response.status in (204, 304) \
                    or 100 <= self.response.status < 200:
                self._finish()
                return
            if "chunked" in h.get("transfer-encoding", "").lower():
                self._state = "chunked"
            elif "content-length" in h:
                self._state = "length"
                self._remaining = int(h["content-length"])
            else:
                self._state = "eof_body"
        if self._state == "length":
            take = min(len(self._buf), self._remaining)
            if take:
                self._emit(self._buf[:take])
                self._buf = self._buf[take:]
                self._remaining -= take
            if self._remaining == 0:
                self._finish()
            return
        if self._state == "eof_body":
            if self._buf:
                self._emit(self._buf)
                self._buf = b""
            return
        while self._state == "chunked":
            if self._remaining > 0:
                take = min(len(self._buf), self._remaining)
                self._emit(self._buf[:take])
                self._buf = self._buf[take:]
                self._remaining -= take
                if self._remaining == 0:
                    # swallow the trailing CRLF
                    self._remaining = -2
                if not self._buf:
                    return
            if self._remaining == -2:
                # skip the CRLF after chunk data (may arrive split)
                if len(self._buf) < 2:
                    return
                self._buf = self._buf[2:]
                self._remaining = 0
            nl = self._buf.find(b"\r\n")
            if nl < 0:
                return
            size = int(self._buf[:nl].split(b";", 1)[0], 16)
            self._buf = self._buf[nl + 2:]
            if size == 0:
                self._finish()
                return
            self._remaining = size
