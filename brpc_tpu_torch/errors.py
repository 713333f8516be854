"""RPC error codes of the port, mirroring bRPC's errno space.

The codes the port's engine and RPC layer set, numbered as in
``brpc_tpu/errors.py`` (bRPC's ``errno.proto``), so both packages put
identical codes on the wire and in logs; negative system errnos pass
through untouched.
"""
from __future__ import annotations

import os

# brpc-compatible error space (errno.proto:20-49)
ENOSERVICE = 1001        # service not found
ENOMETHOD = 1002         # method not found
EREQUEST = 1003          # bad request
ERPCTIMEDOUT = 1008      # RPC deadline exceeded
EFAILEDSOCKET = 1009     # the connection broke during the RPC
EOVERCROWDED = 1011      # too many buffered writes / server overcrowded
EEOF = 1014              # stream EOF

EINTERNAL = 2001         # server-side internal error
ERESPONSE = 2002         # bad response
ELOGOFF = 2003           # server is stopping
ELIMIT = 2004            # concurrency or capacity limit reached

# Locally-originated (client library) codes
ECONNREFUSED = 111
ECANCELED = 125          # call canceled by the caller (StartCancel analog)

_DESCRIPTIONS = {
    ENOSERVICE: "The service was not found",
    ENOMETHOD: "The method was not found",
    EREQUEST: "Bad request",
    ERPCTIMEDOUT: "RPC call timed out",
    EFAILEDSOCKET: "Broken socket during RPC",
    EOVERCROWDED: "The server is overcrowded",
    EEOF: "End of stream",
    EINTERNAL: "Internal server error",
    ERESPONSE: "Bad response",
    ELOGOFF: "Server is stopping",
    ELIMIT: "Reached server's concurrency limit",
    ECANCELED: "The RPC was canceled by the caller",
}


def describe(code: int) -> str:
    if not code:
        return "OK"
    return _DESCRIPTIONS.get(code) or os.strerror(code)


class RpcError(Exception):
    """A definite request failure: ``code`` is one of the constants
    above, ``text`` says why."""

    def __init__(self, code: int, text: str = ""):
        self.code = code
        self.text = text or describe(code)
        super().__init__(f"[E{code}] {self.text}")
