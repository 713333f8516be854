"""Serving registration: the decode engine behind an ordinary port
:class:`~brpc_tpu_torch.rpc.Server`.

A copy of ``brpc_tpu/serving/service.py``'s ``Serving`` service:

  * ``Serving.Generate`` -- streaming, JSON ``{"prompt": [ints...],
    "max_new_tokens": N}`` with a client stream attached
    (``stream_create``); the response is ``{"accepted": true, "req_id":
    id, "prefix_hit": tokens}`` and each generated token arrives as one
    stream message ``{"token": t}``, then ``{"done": true}`` (with
    ``"error"``/``"error_text"`` when the generation failed) and the
    stream's close.  ``"speculative": false`` opts the request out of a
    speculative engine's drafts.
  * ``Serving.Score`` and ``Serving.ScoreT`` answer ENOMETHOD "no
    batcher registered": the batcher comes with its own slice, and
    ``ScoreT``'s tensorframe wire with it (until then ``ScoreT`` takes
    raw bytes).

Left out (ROADMAP): the pull-based ``prefix_fetcher`` (KV migration),
the multi-model ``deployments`` table (model plane) and the chunked
HTTP generate route.
"""
from __future__ import annotations

import json

from .. import errors
from ..rpc.service import Service, method


class ServingService(Service):
    NAME = "Serving"

    def __init__(self, engine=None):
        self._engine = engine

    @method(request="json", response="json")
    def Score(self, cntl, req):
        cntl.set_failed(errors.ENOMETHOD, "no batcher registered")
        return None

    @method(request="raw", response="raw")
    def ScoreT(self, cntl, req):
        cntl.set_failed(errors.ENOMETHOD, "no batcher registered")
        return None

    @method(request="json", response="json")
    def Generate(self, cntl, req):
        engine = self._engine
        if engine is None:
            cntl.set_failed(errors.ENOMETHOD, "no decode engine registered")
            return None
        req = req or {}
        prompt = req.get("prompt") or [0]
        max_new = int(req.get("max_new_tokens", 16))
        stream = cntl.accept_stream()

        def emit(tok: int) -> None:
            # runs on THIS request's emitter thread: a consumer that stops
            # draining the stream's credit window stalls only itself, and
            # once its emit buffer overflows the engine cuts it with
            # EOVERCROWDED at a step boundary; the bound keeps the emitter
            # from wedging on a dead-but-open peer
            stream.write(json.dumps({"token": tok}).encode(), timeout_s=2.0)

        def on_done(err) -> None:
            msg = {"done": True}
            if err is not None:
                msg["error"] = err.code
                msg["error_text"] = err.text
            try:
                stream.write(json.dumps(msg).encode(), timeout_s=2.0)
            except errors.RpcError:
                pass   # the peer is gone; nothing to tell it
            stream.close()

        # advisory prefix probe before submit: how many prompt tokens
        # the KV cache can serve without re-decoding
        hit = 0
        store = getattr(engine, "store", None)
        if store is not None and len(prompt) > 1:
            try:
                hit = int(store.probe(prompt))
            except Exception:
                hit = 0
        kw = {}
        if "speculative" in req:
            # forwarded only when the client says so
            kw["speculative"] = bool(req["speculative"])
        rid = engine.submit(prompt, max_new, emit, on_done, **kw)
        return {"accepted": True, "req_id": rid, "prefix_hit": hit}


def register_serving(server, engine=None) -> ServingService:
    """Register the ``Serving`` service on ``server`` (before
    ``server.start()``)."""
    svc = ServingService(engine)
    server.add_service(svc)
    return svc
