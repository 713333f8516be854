"""Serving registration: the batcher and the decode engine behind an
ordinary port :class:`~brpc_tpu_torch.rpc.Server`.

A copy of ``brpc_tpu/serving/service.py``'s ``Serving`` service and
``ScoreClient``:

  * ``Serving.Generate`` -- streaming, JSON ``{"prompt": [ints...],
    "max_new_tokens": N}`` with a client stream attached
    (``stream_create``); the response is ``{"accepted": true, "req_id":
    id, "prefix_hit": tokens}`` and each generated token arrives as one
    stream message ``{"token": t}``, then ``{"done": true}`` (with
    ``"error"``/``"error_text"`` when the generation failed) and the
    stream's close.  ``"speculative": false`` opts the request out of a
    speculative engine's drafts.  With ``"prefix_holders": [addr, ...]``
    and a ``prefix_fetcher`` registered, a replica whose cache misses
    the prompt's full-page prefix first fetches it from a holder
    (``migrate.make_prefix_fetcher``); a failed fetch falls back to
    recompute.
  * ``Serving.Score`` -- unary, JSON ``{"x": [numbers...]}`` ->
    ``{"y": [...]}``: the handler defers the RPC into the
    :class:`~brpc_tpu_torch.serving.batcher.DynamicBatcher`, whose
    drainer completes it (deadline-doomed requests are shed up front
    with ELIMIT);
  * ``Serving.ScoreT`` -- the same on the tensorframe wire: a rank-1
    tensor field ``"x"`` in, a float32 tensor ``"y"`` out.
  Both answer ENOMETHOD "no batcher registered" without a batcher.
  :class:`ScoreClient` prefers ``ScoreT`` and downgrades to json
  ``Score``, for good, on ENOMETHOD.  Over HTTP, ``POST /Serving/Score``
  with the same JSON body reaches ``Score`` through the console's
  RESTful bridge.
  * ``GET /serving/generate?prompt=1,2,3&max_new_tokens=N`` -- the
    no-TRPC client path (:func:`http_generate_handler`): a chunked
    response of JSON lines, ``{"token": t}`` per token, then
    ``{"done": true}`` (with ``"error"`` when the generation failed).

On the model plane a ``deployments`` table (a
:class:`~brpc_tpu_torch.serving.modelplane.ReplicaDeployments`) resolves
each request's ``model`` field -- Score, ScoreT, Generate and the HTTP
``?model=`` -- to that deployment's engine, batcher and prefix fetcher;
a model the replica does not serve fails EINTERNAL (a failover code)
and counts in ``n_model_misroutes``, and a Generate's response names the
deployment it ran on (``"model"``).
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np

from .. import errors
from ..butil.lockprof import InstrumentedLock
from ..rpc.service import Service, method


class ServingService(Service):
    NAME = "Serving"

    def __init__(self, batcher=None, engine=None, prefix_fetcher=None,
                 deployments=None):
        self._batcher = batcher
        self._engine = engine
        # ``fetch(prompt, holders) -> pages``, usually
        # migrate.make_prefix_fetcher; may be set after the server
        # starts (the fetcher needs the server's own address)
        self.prefix_fetcher = prefix_fetcher
        self.prefix_fetches = 0
        self.prefix_fetched_pages = 0
        # the counters below change on fetch and request threads
        self._mu = InstrumentedLock("serving.service")
        # the model plane: a ReplicaDeployments table maps the forwarded
        # "model" field to per-deployment bindings; None serves the
        # constructor's bindings whatever the field says
        self.deployments = deployments
        self.n_model_misroutes = 0

    def _resolve(self, cntl, model):
        """``(model_key, bindings)`` for a request naming ``model``.
        Without a deployment table the constructor's bindings serve it.
        A model this replica does not serve fails EINTERNAL -- a
        failover code, so the router's session driver re-routes instead
        of killing the session -- and adds one to ``n_model_misroutes``
        (0 in a healthy fleet: the router picks from its catalog);
        ``(None, None)`` then."""
        if self.deployments is None or len(self.deployments) == 0:
            return None, {"engine": self._engine, "batcher": self._batcher,
                          "prefix_fetcher": self.prefix_fetcher}
        try:
            key, row = self.deployments.resolve(model or None)
        except KeyError:
            with self._mu:
                self.n_model_misroutes += 1
            cntl.set_failed(
                errors.EINTERNAL,
                f"model {model!r} not served by this replica "
                f"(serves {self.deployments.keys()})")
            return None, None
        return key, {"engine": row.get("engine") or self._engine,
                     "batcher": row.get("batcher") or self._batcher,
                     "prefix_fetcher": (row.get("prefix_fetcher")
                                        or self.prefix_fetcher)}

    @method(request="json", response="json")
    def Score(self, cntl, req):
        _, b = self._resolve(cntl, (req or {}).get("model"))
        if b is None:
            return None
        batcher = b["batcher"]
        if batcher is None:
            cntl.set_failed(errors.ENOMETHOD, "no batcher registered")
            return None
        x = (req or {}).get("x")
        if x is None:
            cntl.set_failed(errors.EREQUEST, 'missing "x"')
            return None
        batcher.submit(
            cntl, np.asarray(x, dtype=np.float32),
            transform=lambda row: {"y": np.asarray(row).tolist()})
        return None   # deferred: the batch drainer completes the RPC

    @method(request="tensorframe", response="tensorframe")
    def ScoreT(self, cntl, req):
        """Score on the binary tensor wire: the row rides as a float32
        tensor field both ways."""
        _, b = self._resolve(cntl, (req or {}).get("model"))
        if b is None:
            return None
        batcher = b["batcher"]
        if batcher is None:
            cntl.set_failed(errors.ENOMETHOD, "no batcher registered")
            return None
        x = (req or {}).get("x")
        if not isinstance(x, np.ndarray) or x.ndim != 1:
            cntl.set_failed(errors.EREQUEST,
                            'need rank-1 tensor field "x"')
            return None
        batcher.submit(
            cntl, np.asarray(x, dtype=np.float32),
            transform=lambda row: {"y": np.asarray(row, np.float32)})
        return None   # deferred: the batch drainer completes the RPC

    @method(request="json", response="json")
    def Generate(self, cntl, req):
        model_key, b = self._resolve(cntl, (req or {}).get("model"))
        if b is None:
            return None
        engine = b["engine"]
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
            if err is None and model_key is not None:
                # the warm-up proof: a finished generation flips its
                # deployment loading -> warm on the published catalog
                self.deployments.note_generation(model_key)
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

        def submit(hit: int) -> dict:
            rid = engine.submit(prompt, max_new, emit, on_done, **kw)
            resp = {"accepted": True, "req_id": rid, "prefix_hit": hit}
            if model_key is not None:
                resp["model"] = model_key
            return resp

        holders = req.get("prefix_holders") or []
        fetcher = b["prefix_fetcher"]
        if (fetcher is not None and holders
                and store is not None and len(prompt) > 1):
            full = len(prompt) // store.page_tokens * store.page_tokens
            if full and hit < full:
                # the fetch waits on this process's own OfferT: it runs
                # off the executor (migrate.run_off_executor)
                from ..migrate.plane import run_off_executor
                run_off_executor(cntl, lambda: submit(max(
                    hit, self._fetch(fetcher, store, prompt, holders))),
                    "prefix_fetch")
                return None
        return submit(hit)

    def _fetch(self, fetcher, store, prompt, holders) -> int:
        """Fetch the prompt's prefix from a holder; the prefix hit after
        it (0 when the fetch failed: the engine recomputes)."""
        try:
            fetched = int(fetcher([int(t) for t in prompt],
                                  [str(h) for h in holders]))
        except Exception:
            return 0
        if not fetched:
            return 0
        with self._mu:     # fetches finish on their own threads
            self.prefix_fetches += 1
            self.prefix_fetched_pages += fetched
        return int(store.probe(prompt))


class ScoreClient:
    """The client half of Score: prefers the binary ``ScoreT`` wire and
    downgrades, for good, to json ``Score`` when the peer answers
    ENOMETHOD (a server without ``ScoreT``).  Both paths return the same
    float32 rows."""

    def __init__(self, channel):
        self._ch = channel
        self._mode: Optional[str] = None     # None | "frame" | "json"
        self.n_negotiation_fallbacks = 0

    @property
    def wire_mode(self) -> Optional[str]:
        return self._mode

    def score(self, x, **kw) -> np.ndarray:
        x = np.ascontiguousarray(x, dtype=np.float32)
        if self._mode != "json":
            try:
                resp = self._ch.call_sync(
                    "Serving", "ScoreT", {"x": x},
                    serializer="tensorframe", **kw)
                self._mode = "frame"
                return np.asarray(resp["y"], np.float32)
            except errors.RpcError as e:
                if e.code != errors.ENOMETHOD:
                    raise
                self._mode = "json"
                self.n_negotiation_fallbacks += 1
        resp = self._ch.call_sync("Serving", "Score", {"x": x.tolist()},
                                  serializer="json", **kw)
        return np.asarray(resp["y"], np.float32)


def http_generate_handler(engine, deployments=None):
    """An HTTP handler streaming decode tokens as chunked JSON lines
    through a ProgressiveAttachment: the no-TRPC client path.  With a
    ``deployments`` table (a ``ReplicaDeployments``), ``?model=`` picks
    the deployment as ``Serving.Generate``'s ``model`` field does; a
    model this replica does not serve answers 404."""
    from ..builtin.router import http_response
    from ..rpc.progressive import ProgressiveResponse

    def handler(req):
        try:
            prompt = [int(t) for t in
                      (req.query.get("prompt") or "0").split(",") if t]
            max_new = int(req.query.get("max_new_tokens", "16"))
        except ValueError as e:
            return http_response(400, f"bad query: {e}\n")
        eng, key = engine, None
        if deployments is not None and len(deployments):
            model = req.query.get("model") or None
            try:
                key, row = deployments.resolve(model)
            except KeyError:
                return http_response(
                    404, f"model {model!r} not served by this replica "
                         f"(serves {deployments.keys()})\n")
            eng = row.get("engine") or engine
        if eng is None:
            return http_response(404, "no decode engine registered\n")

        def writer(pa):
            def emit(tok: int) -> None:
                # write returns -1 (never raises) once the connection
                # died; raising here makes the engine retire the slot
                # instead of decoding to nobody
                if pa.write(json.dumps({"token": tok}) + "\n") != 0:
                    raise errors.RpcError(errors.EFAILEDSOCKET,
                                          "http client gone")

            def on_done(err) -> None:
                if err is None and key is not None:
                    deployments.note_generation(key)
                msg = {"done": True}
                if err is not None:
                    msg["error"] = err.code
                pa.write(json.dumps(msg) + "\n")
                pa.close()

            eng.submit(prompt, max_new, emit, on_done)

        return ProgressiveResponse(writer,
                                   content_type="application/json-seq")

    return handler


def register_serving(server, batcher=None, engine=None,
                     prefix_fetcher=None, deployments=None,
                     http_generate_path: Optional[str]
                     = "/serving/generate") -> ServingService:
    """Register the serving surface on ``server`` (before
    ``server.start()``): the ``Serving`` service -- ``batcher`` answers
    Score/ScoreT, ``engine`` (a DecodeEngine or an EngineSupervisor)
    Generate, ``prefix_fetcher`` warms a cache miss from the request's
    ``prefix_holders``, ``deployments`` (a ``ReplicaDeployments``) maps
    the request's ``model`` field to a deployment's own bindings -- and,
    with an engine or deployments, the chunked HTTP generate route at
    ``http_generate_path`` (None: no route)."""
    svc = ServingService(batcher, engine, prefix_fetcher,
                         deployments=deployments)
    server.add_service(svc)
    if (engine is not None or deployments is not None) \
            and http_generate_path:
        server.add_http_handler(
            http_generate_path, http_generate_handler(engine, deployments))
    return svc
