"""Builtin HTTP console router (a copy of ``brpc_tpu/builtin/router.py``).

Serves the console pages on the SAME port as RPC traffic: the native
core detects HTTP and hands each whole request here.  Routes come from
``builtin/services.py``; this module parses requests, resolves the
handler (user handlers first, then exact routes, then the longest
prefix route behind an MRU cache, then the RESTful bridge onto RPC
methods) and frames responses.  Handlers run inline on the thread that
delivered the request; a RESTful call whose method defers is answered
later, by the thread that completes it.
"""
from __future__ import annotations

import json
import traceback
from urllib.parse import parse_qs, urlparse

from .. import errors
from ..butil.containers import CaseIgnoredDict, MRUCache
from ..rpc.progressive import ProgressiveAttachment, ProgressiveResponse
from ..rpc.transport import Transport


class HttpRequest:
    def __init__(self, raw: bytes):
        head, _, self.body = raw.partition(b"\r\n\r\n")
        lines = head.split(b"\r\n")
        parts = lines[0].decode("latin1").split(" ")
        self.method = parts[0]
        target = parts[1] if len(parts) > 1 else "/"
        u = urlparse(target)
        self.path = u.path
        self.query = {k: v[0] for k, v in parse_qs(u.query).items()}
        # case-insensitive lookup, original casing preserved
        self.headers = CaseIgnoredDict()
        for ln in lines[1:]:
            k, _, v = ln.decode("latin1").partition(":")
            self.headers[k.strip()] = v.strip()


def http_response(status: int, body: bytes | str,
                  content_type: str = "text/plain; charset=utf-8",
                  extra_headers: dict | None = None) -> bytes:
    if isinstance(body, str):
        body = body.encode()
    reason = {200: "OK", 404: "Not Found", 500: "Internal Server Error",
              400: "Bad Request", 302: "Found"}.get(status, "OK")
    hdr = [f"HTTP/1.1 {status} {reason}",
           f"Content-Type: {content_type}",
           f"Content-Length: {len(body)}"]
    for k, v in (extra_headers or {}).items():
        hdr.append(f"{k}: {v}")
    hdr.append("\r\n")
    return "\r\n".join(hdr).encode() + body


class HttpRouter:
    _MISS = object()   # "path not yet resolved" (None is a valid,
                       # cacheable "no prefix route" outcome)

    def __init__(self, server):
        self.server = server
        from .services import build_routes
        self.routes = build_routes(server)
        # longest-prefix resolution scans every route; console paths
        # repeat, so memoize path -> prefix handler (the routes never
        # change after build, which makes the cache sound)
        self._prefix_cache = MRUCache(capacity=256)

    def handle(self, sid: int, raw: bytes) -> None:
        t = Transport.instance()
        try:
            req = HttpRequest(raw)
        except Exception:
            t.write_raw(sid, http_response(400, "bad request"))
            return
        handler = self.server._http_handlers.get(req.path) or \
            self.routes.get(req.path)
        if handler is None:
            handler = self._prefix_cache.get(req.path, self._MISS)
            if handler is self._MISS:
                handler, best = None, ""
                for prefix, h in self.routes.items():
                    if len(prefix) > 1 and prefix.endswith("/") and \
                            req.path.startswith(prefix) and \
                            len(prefix) > len(best):
                        handler, best = h, prefix
                self._prefix_cache.put(req.path, handler)
            if handler is None and req.path.startswith("/") and \
                    self._try_rpc(sid, req):
                return
        if handler is None:
            t.write_raw(sid, http_response(
                404, f"no handler for {req.path!r}\n"))
            return
        try:
            resp = handler(req) if callable(handler) else handler
            if isinstance(resp, ProgressiveResponse):
                # chunked server push
                hdr = [f"HTTP/1.1 {resp.status} OK",
                       f"Content-Type: {resp.content_type}",
                       "Transfer-Encoding: chunked"]
                for k, v in resp.extra_headers.items():
                    hdr.append(f"{k}: {v}")
                hdr.append("\r\n")
                t.write_raw(sid, "\r\n".join(hdr).encode())
                resp.writer(ProgressiveAttachment(sid))
            elif isinstance(resp, bytes) and resp.startswith(b"HTTP/1."):
                t.write_raw(sid, resp)
            else:
                body, ctype = resp if isinstance(resp, tuple) else \
                    (resp, "text/plain; charset=utf-8")
                t.write_raw(sid, http_response(200, body, ctype))
        except Exception:
            t.write_raw(sid, http_response(500, traceback.format_exc()))

    def _try_rpc(self, sid: int, req: HttpRequest) -> bool:
        """The RESTful bridge: ``POST /Service/Method`` with a JSON body
        calls the RPC method through ``Server.invoke_restful``, which
        writes the response when the method completes.  False when the
        path names no method."""
        parts = [p for p in req.path.split("/") if p]
        if len(parts) != 2 or \
                self.server._methods.get((parts[0], parts[1])) is None:
            return False
        t = Transport.instance()
        try:
            payload = json.loads(req.body) if req.body.strip() else None
        except json.JSONDecodeError as e:
            t.write_raw(sid, http_response(
                400, json.dumps({"error": errors.EREQUEST,
                                 "text": f"bad JSON body: {e}"}),
                "application/json"))
            return True

        def reply(code: int, text: str, result) -> None:
            if code == 0:
                body, status = json.dumps(result, default=str), 200
            else:
                body = json.dumps({"error": code, "text": text})
                status = 401 if code == errors.ERPCAUTH else \
                    503 if code in (errors.ELIMIT, errors.ELOGOFF) else 500
            t.write_raw(sid, http_response(status, body, "application/json"))

        self.server.invoke_restful(parts[0], parts[1], payload, reply)
        return True
