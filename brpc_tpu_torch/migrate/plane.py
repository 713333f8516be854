"""Cross-replica KV page migration: the data plane's page-shipping core.

Port of ``brpc_tpu/migrate/plane.py``.  A radix prefix's pages, with the
tree metadata that makes them meaningful (token runs, per-chunk
fingerprints, refcounts at the source), ship to a peer's ``_kvmig``
service and splice into its :class:`~brpc_tpu_torch.kvcache.KVCacheStore`
as COMMITTED radix nodes, so the peer prefix-hits state it never
computed.  Page bytes are the reference's (``[n_layers, 2, n_kv_heads,
head_dim]`` f32 per token), so a port replica and a reference replica
exchange prefixes both ways.

Wire: ``OfferT`` (tensorframe: token runs, fingerprints and refcounts as
tensors, the pages as one uint8 tensor, a small json remainder) first;
a peer answering ENOMETHOD downgrades the destination, for good, to
``Offer`` (the bounded-trust json-header envelope of ``ici/dcn.py``).
Both decode to the same ``(header, arrays)`` and feed one splice path.

The port has no transfer fabric, so every migration is host-serialized:
the source gathers the pages into one device tensor
(``PagePool.stack_pages``) and copies it to the host once per
migration; the destination copies the payload to its device once and
splices page by page (``import_prefix``).  ``kvcache_migrate_fallback``
counts every migration, ``kvcache_migrate_zero_copy`` stays 0.

Failure semantics: ``fault.MIGRATE_SEND`` fires on the source before
anything leaves the process, ``fault.MIGRATE_RECV`` on the destination
before anything is spliced, ``fault.MIGRATE_SPLICE`` (kvcache/store.py)
mid-splice.  Whatever fires, the source's pins are released, the
destination fully splices or fully rolls back, and the caller
recomputes: migration is an optimisation, never a correctness
dependency.

Observability: migrations run under rpcz spans that join the caller's
trace over the envelope's trace fields; the destination's splice span
links the source's migrate span through ``migrated_from``.  Migration
threads are stage-tagged ``migrate``; the ``kvcache_migrate_*`` adders
and the splice latency recorder count the plane.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Optional, Sequence

import numpy as np

from .. import errors, fault, rpcz
from ..butil import stagetag
from ..butil.lockprof import InstrumentedLock
from ..bvar import Adder
from ..ici import dcn
from ..kvcache.store import MissingShippedPrefix
from ..rpc.service import Service, method
from . import _register_migrator, _register_service

MIGRATE_SERVICE = "_kvmig"

migrate_pages = Adder("kvcache_migrate_pages")
migrate_bytes = Adder("kvcache_migrate_bytes")
migrations_ok = Adder("kvcache_migrations_ok")
migrations_failed = Adder("kvcache_migrations_failed")
migrate_rollbacks = Adder("kvcache_migrate_rollbacks")
migrate_zero_copy = Adder("kvcache_migrate_zero_copy")
migrate_fallback = Adder("kvcache_migrate_fallback")
migrate_offer_frames = Adder("kvcache_migrate_offer_frames")

_mig_ids = itertools.count(1)
_splice_rec = None
_splice_rec_mu = InstrumentedLock("migrate.splice_rec")


def splice_recorder():
    """The ``kvcache_migrate_splice_us`` LatencyRecorder, made at first
    use: it lives in the port's native core, which importing this module
    must not build."""
    global _splice_rec
    with _splice_rec_mu:
        if _splice_rec is None:
            from ..bvar import LatencyRecorder
            _splice_rec = LatencyRecorder("kvcache_migrate_splice_us")
        return _splice_rec


def _envelope_frame_fields(header: dict, arrays: list) -> dict:
    """The Offer envelope as tensorframe fields: token runs,
    fingerprints (uint64: they may exceed int64) and refcounts as
    little-endian tensors, the pages as one uint8 tensor, the rest of
    the header as json bytes.  :func:`_frame_envelope` gives back
    exactly the ``(header, arrays)`` the json envelope decodes to."""
    hdr = dict(header)
    fields = {
        "tokens": np.asarray(hdr.pop("tokens", []), np.int64),
        "fingerprints": np.asarray(hdr.pop("fingerprints", []), np.uint64),
        "refcounts": np.asarray(hdr.pop("refcounts", []), np.int64),
        "hdr": json.dumps(hdr).encode(),
    }
    if arrays:
        fields["pages"] = np.ascontiguousarray(arrays[0], np.uint8)
    return fields


def _frame_envelope(req: dict) -> tuple[dict, list]:
    """Inverse of :func:`_envelope_frame_fields`."""
    hdr = json.loads(bytes(req["hdr"]).decode())
    hdr["tokens"] = [int(t) for t in np.asarray(req["tokens"])]
    hdr["fingerprints"] = [int(f) for f in np.asarray(req["fingerprints"])]
    hdr["refcounts"] = [int(r) for r in np.asarray(req["refcounts"])]
    arrays = [np.asarray(req["pages"], np.uint8)] if "pages" in req else []
    return hdr, arrays


def run_off_executor(cntl, fn, name: str):
    """Answer the RPC with ``fn()``'s result from a ``migrate``-stage
    thread instead of the handler's executor worker.  A handler whose
    work waits on another ``_kvmig`` call (``PushTo`` waits on the
    destination's ``OfferT``; a fetching ``Generate`` waits on the
    holder's ``PushTo``) must not hold a worker meanwhile: when such
    handlers fill every worker of the process that should answer the
    inner call, nothing serves it and the outer call waits on itself
    until its deadline.  An RpcError from ``fn`` fails the RPC with its
    code; the handler's span stays current on the thread, so the inner
    calls join its trace."""
    done = cntl.defer()
    span = rpcz.get_current_span()

    def run() -> None:
        rpcz.set_current_span(span)
        resp = None
        try:
            with stagetag.stage("migrate"):
                resp = fn()
        except errors.RpcError as e:
            cntl.set_failed(e.code, e.text)
        except Exception as e:
            cntl.set_failed(errors.EINTERNAL, f"{type(e).__name__}: {e}")
        finally:
            rpcz.set_current_span(None)
        done(resp)

    threading.Thread(target=run, daemon=True, name=name).start()


def chunk_fingerprints(tokens: Sequence[int], page_tokens: int) -> list:
    """Per-full-page-chunk 64-bit fingerprints of `tokens`, the tree
    metadata that travels with migrated pages.  The destination
    recomputes them from the token runs it received and refuses a
    migration whose fingerprints disagree."""
    from ..policy.load_balancer import _hash_murmur_like
    pt = page_tokens
    out = []
    for i in range(len(tokens) // pt):
        chunk = tokens[i * pt:(i + 1) * pt]
        out.append(_hash_murmur_like(b"".join(
            (int(t) & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little")
            for t in chunk)))
    return out


class PageMigrator:
    """Source half: exports a committed radix prefix of `store` and
    ships it to a peer's ``_kvmig`` service (see the module docstring).
    One migrator per store; destination channels are cached."""

    # per-destination incremental-shipping memory: chains cached beyond
    # this are dropped wholesale (a clear only costs re-shipping)
    MAX_CACHED_CHAINS = 8192

    def __init__(self, store, *, name: str = "migrator",
                 timeout_ms: int = 10_000, model: str = ""):
        self.store = store
        self.name = name
        self.timeout_ms = int(timeout_ms)
        # the model plane: the deployment this store's pages belong to,
        # the default tag of every fetch (see MigrateService)
        self.model = str(model or "")
        self._mu = InstrumentedLock("migrate.plane")
        self._chans: dict[str, dcn.DcnChannel] = {}
        self.routes: dict[str, dict] = {}
        # dest -> fingerprint-chain tuples already shipped there: a
        # repeat prefix ships only its un-shipped suffix pages
        self._shipped: dict[str, set] = {}
        self.fetch_routes: dict[str, dict] = {}
        # dest -> "frame" | "legacy" (sticky after an ENOMETHOD)
        self._wire_mode: dict[str, str] = {}
        self.n_negotiation_fallbacks = 0
        _register_migrator(self)

    def _channel(self, dest: str) -> dcn.DcnChannel:
        with self._mu:
            ch = self._chans.get(dest)
            if ch is None:
                ch = dcn.DcnChannel(dest, timeout_ms=self.timeout_ms,
                                    device=self.store.device)
                self._chans[dest] = ch
        return ch

    def _route(self, dest: str) -> dict:
        with self._mu:
            r = self.routes.get(dest)
            if r is None:
                r = {"migrations": 0, "pages": 0, "bytes": 0,
                     "failed": 0, "zero_copy": 0}
                self.routes[dest] = r
            return r

    def migrate(self, tokens: Sequence[int], dest: str, *,
                trace_ctx: Optional[tuple] = None) -> int:
        """Ship the longest COMMITTED full-page prefix of `tokens` to
        `dest`'s store; returns the pages it covers (0 when none is
        committed here).  Raises RpcError on a transport or splice
        failure; the source pages are released either way.
        ``trace_ctx=(trace_id, parent_span_id, sampled)`` joins an
        existing trace; by default the current span's is inherited."""
        with stagetag.stage("migrate"):
            return self._migrate(tokens, dest, trace_ctx)

    def _migrate(self, tokens, dest, trace_ctx) -> int:
        tokens = [int(t) for t in tokens]
        if trace_ctx is not None:
            tid, psid, smp = trace_ctx
            span = rpcz.new_span("migrate", "KvMigrate", "Offer",
                                 trace_id=tid, parent_span_id=psid,
                                 sampled=smp if tid else None)
        else:
            span = rpcz.child_span("migrate", "KvMigrate", "Offer")
        span.remote_side = dest
        route = self._route(dest)
        hit, pages = self.store.acquire_pages(tokens)
        try:
            if not pages:
                span.annotate("nothing committed to migrate")
                return 0
            return self._ship(tokens, dest, span, route, pages)
        except errors.RpcError as e:
            self._failed(route)
            span.error_code = e.code
            span.annotate(f"migration failed: {e.text}")
            raise
        except Exception as e:
            self._failed(route)
            span.error_code = errors.EINTERNAL
            span.annotate(f"migration failed: {type(e).__name__}: {e}")
            raise errors.RpcError(
                errors.EINTERNAL, f"page migration to {dest} failed: "
                f"{type(e).__name__}: {e}") from e
        finally:
            # the pins outlive the send, never more
            self.store.release(pages)
            rpcz.submit(span)

    def _failed(self, route: dict) -> None:
        migrations_failed.add(1)
        with self._mu:
            route["failed"] += 1

    def _shipped_prefix(self, dest: str, fps: list) -> int:
        """Longest fingerprint-chain prefix already shipped to `dest`."""
        with self._mu:
            chains = self._shipped.get(dest)
            if not chains:
                return 0
            have = 0
            for k in range(1, len(fps) + 1):
                if tuple(fps[:k]) not in chains:
                    break
                have = k
            return have

    def _remember_shipped(self, dest: str, fps: list) -> None:
        with self._mu:
            chains = self._shipped.setdefault(dest, set())
            if len(chains) > self.MAX_CACHED_CHAINS:
                chains.clear()
            for k in range(1, len(fps) + 1):
                chains.add(tuple(fps[:k]))

    def _ship(self, tokens, dest, span, route, pages) -> int:
        if fault.ENABLED and fault.hit(fault.MIGRATE_SEND,
                                       dest=dest) is not None:
            raise errors.RpcError(errors.EINTERNAL,
                                  f"injected migration send loss to {dest}")
        pt = self.store.page_tokens
        nfull = len(pages)
        toks = tokens[:nfull * pt]
        fps = chunk_fingerprints(toks, pt)
        have = self._shipped_prefix(dest, fps)
        if have >= nfull:
            # the whole chain already shipped: if the destination has
            # since evicted it, its next admit recomputes
            span.annotate(f"already shipped: all {nfull} pages cached "
                          f"at {dest}")
            return nfull
        try:
            return self._ship_chunks(toks, dest, span, route, pages, fps,
                                     have)
        except errors.RpcError as e:
            if have and "missing shipped prefix" in (e.text or ""):
                # the destination evicted chunks we skipped: forget them
                # and send the full chain once
                with self._mu:
                    self._shipped.pop(dest, None)
                span.annotate(f"incremental send refused (dest evicted "
                              f"{have}-chunk prefix); retrying full")
                return self._ship_chunks(toks, dest, span, route, pages,
                                         fps, 0)
            raise

    def _ship_chunks(self, toks, dest, span, route, pages, fps,
                     have: int) -> int:
        pt = self.store.page_tokens
        pb = self.store.pagepool.page_bytes
        nfull = len(pages)
        send = pages[have:]
        ch = self._channel(dest)
        try:
            ch.handshake()
        except errors.RpcError:
            pass      # a peer without _dcn: the control RPC still works
        header = {
            "mig_id": next(_mig_ids),
            "tokens": toks,
            "page_tokens": pt,
            "page_bytes": pb,
            "have": have,
            "fingerprints": fps,
            "refcounts": [self.store.pagepool.refs(p) for p in pages],
            "src": self.store.name,
            "src_span_id": span.span_id,
        }
        if span.trace_id:
            # the destination's splice span lands in this trace
            header["trace_id"] = span.trace_id
            header["parent_span_id"] = span.span_id
            header["trace_sampled"] = span.sampled
        # host-serialized (no fabric): one gather on the device, one
        # copy to the host for the whole migration
        arrays = [self.store.pagepool.stack_pages(send).cpu().numpy()]
        migrate_fallback.add(1)
        span.annotate(f"host-serialized: pages {have}..{nfull} "
                      f"({len(send) * pb}B on the envelope)")
        hdr = self._post_offer(ch, dest, header, arrays, span)
        retained = int(hdr.get("imported", 0))
        span.annotate(f"destination spliced: {retained}/{len(send)} sent "
                      f"pages newly retained (dst span "
                      f"{hdr.get('dst_span_id', 0)})")
        self._remember_shipped(dest, fps)
        migrations_ok.add(1)
        migrate_pages.add(len(send))
        migrate_bytes.add(len(send) * pb)
        with self._mu:
            route["migrations"] += 1
            route["pages"] += len(send)
            route["bytes"] += len(send) * pb
        return nfull

    def _post_offer(self, ch, dest: str, header: dict, arrays: list,
                    span) -> dict:
        """One Offer, ``OfferT`` first, downgrading for good to the json
        envelope when the peer answers ENOMETHOD.  Returns the reply
        header."""
        with self._mu:
            mode = self._wire_mode.get(dest)
        if mode != "legacy":
            fields = _envelope_frame_fields(header, arrays)
            span.request_size = sum(
                v.nbytes if isinstance(v, np.ndarray) else len(v)
                for v in fields.values())
            try:
                resp = ch.channel.call_sync(MIGRATE_SERVICE, "OfferT",
                                            fields,
                                            serializer="tensorframe")
                with self._mu:
                    self._wire_mode[dest] = "frame"
                migrate_offer_frames.add(1)
                return dict(resp or {})
            except errors.RpcError as e:
                if e.code != errors.ENOMETHOD:
                    raise
                with self._mu:
                    self._wire_mode[dest] = "legacy"
                    self.n_negotiation_fallbacks += 1
                span.annotate(f"peer {dest} lacks OfferT; json-envelope "
                              f"downgrade")
        body = dcn._pack_envelope(header, arrays)
        span.request_size = len(body)
        raw = ch.channel.call_sync(MIGRATE_SERVICE, "Offer", body,
                                   serializer="raw",
                                   response_serializer="raw")
        hdr, _ = dcn._unpack_envelope(bytes(raw))
        span.response_size = len(raw)
        return hdr

    def fetch(self, tokens: Sequence[int], src: str, dest: str,
              model: Optional[str] = None) -> int:
        """Pull-based warm-up: ask `src`'s ``_kvmig`` to push `tokens`'
        committed prefix to `dest` (normally this replica's own
        address).  Returns the pages landed (0 when the owner holds
        none); raises RpcError on a dead or refusing owner, and the
        caller recomputes.  ``model`` (default: the migrator's own tag)
        tags the request: an owner tagged with another model refuses
        it, so a stale holder list cannot splice one model's pages into
        another's store."""
        model = self.model if model is None else str(model)
        with stagetag.stage("migrate"):
            if fault.ENABLED and fault.hit(fault.PREFIX_FETCH,
                                           src=src) is not None:
                with self._mu:
                    self._fetch_route(src)["failed"] += 1
                raise errors.RpcError(
                    errors.EINTERNAL,
                    f"injected prefix fetch failure from {src}")
            ch = self._channel(str(src))
            req = {"tokens": [int(t) for t in tokens], "dest": str(dest)}
            if model:
                req["model"] = model
            try:
                out = ch.channel.call_sync(
                    MIGRATE_SERVICE, "PushTo", req, serializer="json",
                    response_serializer="json")
            except errors.RpcError:
                with self._mu:
                    self._fetch_route(src)["failed"] += 1
                raise
            pages = int((out or {}).get("migrated_pages", 0))
            with self._mu:
                r = self._fetch_route(src)
                r["fetches"] += 1
                r["pages"] += pages
            return pages

    def _fetch_route(self, src: str) -> dict:
        # caller holds self._mu
        r = self.fetch_routes.get(src)
        if r is None:
            r = {"fetches": 0, "pages": 0, "failed": 0}
            self.fetch_routes[src] = r
        return r

    def stats(self) -> dict:
        with self._mu:
            routes = {d: dict(r) for d, r in self.routes.items()}
            fetches = {s: dict(r) for s, r in self.fetch_routes.items()}
            modes = dict(self._wire_mode)
            fallbacks = self.n_negotiation_fallbacks
        return {"store": self.store.name, "routes": routes,
                "fetch_routes": fetches, "wire_modes": modes,
                "negotiation_fallbacks": fallbacks}


class MigrateService(Service):
    """Destination half: receives ``Offer``/``OfferT``, checks the page
    geometry and the chunk fingerprints, and splices the pages into the
    local store as committed radix nodes, all or nothing.  ``PushTo``
    lets a coordinator ask THIS process to push one of its prefixes to
    another replica."""

    NAME = MIGRATE_SERVICE

    def __init__(self, store, *, migrator: Optional[PageMigrator] = None,
                 model: str = ""):
        self.store = store
        self.migrator = migrator or PageMigrator(
            store, name=f"{store.name}_pusher", model=model)
        # the model plane: the deployment this store's pages belong to.
        # "" accepts any PushTo; a tagged service refuses one that names
        # a DIFFERENT model, so pages never cross models
        self.model = str(model or "")
        self.n_model_refusals = 0
        self._mu = InstrumentedLock("migrate.service")
        self.inbound: dict[str, dict] = {}
        _register_service(self)

    def _inbound(self, src: str) -> dict:
        with self._mu:
            r = self.inbound.get(src)
            if r is None:
                r = {"migrations": 0, "pages": 0, "bytes": 0,
                     "rolled_back": 0}
                self.inbound[src] = r
            return r

    @method(request="raw", response="raw")
    def Offer(self, cntl, req):
        with stagetag.stage("migrate"):
            try:
                hdr, arrays = dcn._unpack_envelope(bytes(req))
            except Exception as e:
                cntl.set_failed(errors.EREQUEST,
                                f"bad migration envelope: {e}")
                return None
            resp = self._splice(cntl, hdr, arrays)
            return None if resp is None else dcn._pack_envelope(resp, [])

    @method(request="tensorframe", response="tensorframe")
    def OfferT(self, cntl, req):
        """The same Offer on the tensorframe wire."""
        with stagetag.stage("migrate"):
            try:
                hdr, arrays = _frame_envelope(req or {})
            except Exception as e:
                cntl.set_failed(errors.EREQUEST,
                                f"bad migration envelope: {e}")
                return None
            return self._splice(cntl, hdr, arrays)

    def _splice(self, cntl, hdr, arrays):
        if fault.ENABLED and fault.hit(fault.MIGRATE_RECV,
                                       store=self.store.name) is not None:
            cntl.set_failed(errors.EINTERNAL, "injected migration recv loss")
            return None
        try:
            toks = [int(t) for t in hdr["tokens"]]
            pt = int(hdr["page_tokens"])
            pb = int(hdr["page_bytes"])
            have = int(hdr.get("have", 0))
            fps = [int(f) for f in hdr.get("fingerprints") or []]
        except Exception as e:
            cntl.set_failed(errors.EREQUEST, f"bad migration envelope: {e}")
            return None
        if pt != self.store.page_tokens \
                or pb != self.store.pagepool.page_bytes:
            cntl.set_failed(
                errors.EREQUEST,
                f"page geometry mismatch: peer ships {pt} tokens x {pb}B "
                f"pages, this store holds {self.store.page_tokens} x "
                f"{self.store.pagepool.page_bytes}B")
            return None
        if fps != chunk_fingerprints(toks, pt):
            cntl.set_failed(errors.EREQUEST,
                            "chunk fingerprint mismatch: migration "
                            "metadata does not describe its token runs")
            return None
        # the splice span joins the source's trace and links its migrate
        # span (the cross-process mirror of recovered_from)
        try:
            env_tid = int(hdr.get("trace_id") or 0)
            env_psid = int(hdr.get("parent_span_id") or 0)
        except (TypeError, ValueError):
            env_tid = env_psid = 0
        if env_tid:
            span = rpcz.new_span("migrate", "KvMigrate", "Splice",
                                 trace_id=env_tid, parent_span_id=env_psid,
                                 sampled=bool(hdr.get("trace_sampled",
                                                      True)))
        else:
            span = rpcz.new_span("migrate", "KvMigrate", "Splice")
        span.migrated_from = int(hdr.get("src_span_id") or 0)
        nsent = len(toks) // pt - have
        span.annotate(f"migration from store {hdr.get('src', '?')}: "
                      f"{len(toks)} tokens (chunks {have}..{len(toks) // pt}"
                      f" on the wire), source refcounts "
                      f"{hdr.get('refcounts')}")
        route = self._inbound(str(hdr.get("src", "?")))
        try:
            if not arrays:
                raise ValueError("no page payload on the envelope")
            rows = np.asarray(arrays[0], np.uint8).reshape(-1, pb)
            if rows.shape[0] != nsent:
                raise ValueError(f"{rows.shape[0]} payload pages for "
                                 f"chunks {have}..{len(toks) // pt}")
            t0 = time.monotonic()
            retained = self.store.import_prefix(toks, rows, have=have,
                                                span=span)
            splice_recorder().add(int((time.monotonic() - t0) * 1e6))
        except MissingShippedPrefix as e:
            # not a rollback: the peer's incremental assumption was
            # stale; a definite refusal makes it send the full chain
            span.error_code = errors.EREQUEST
            span.annotate(f"incremental import refused: {e}")
            rpcz.submit(span)
            cntl.set_failed(errors.EREQUEST, f"missing shipped prefix: {e}")
            return None
        except Exception as e:
            # import_prefix rolled its pages back; the source gets a
            # definite error and recomputes
            migrate_rollbacks.add(1)
            with self._mu:
                route["rolled_back"] += 1
            span.error_code = errors.EINTERNAL
            span.annotate(f"splice rolled back: {type(e).__name__}: {e}")
            rpcz.submit(span)
            cntl.set_failed(errors.EINTERNAL, f"migration splice failed: "
                                              f"{type(e).__name__}: {e}")
            return None
        with self._mu:
            route["migrations"] += 1
            route["pages"] += nsent
            route["bytes"] += nsent * pb
        resp = {"imported": retained, "pages": nsent,
                "dst_span_id": span.span_id}
        rpcz.submit(span)
        return resp

    @method(request="json", response="json")
    def PushTo(self, cntl, req):
        """Migrate `tokens`' committed prefix FROM this store TO `dest`:
        what the balancer's rebalance hook and a prefix fetch ask of a
        prefix's owner."""
        req = req or {}
        tokens = req.get("tokens") or []
        dest = req.get("dest")
        if not tokens or not dest:
            cntl.set_failed(errors.EREQUEST,
                            'PushTo needs "tokens" and "dest"')
            return None
        want = str(req.get("model") or "")
        if want and self.model and want != self.model:
            with self._mu:
                self.n_model_refusals += 1
            cntl.set_failed(
                errors.EREQUEST,
                f"model mismatch: this store holds {self.model!r} "
                f"pages, refusing a {want!r} fetch")
            return None

        def push() -> dict:
            try:
                pages = self.migrator.migrate(tokens, str(dest))
            except errors.RpcError as e:
                raise errors.RpcError(
                    e.code, f"push migration failed: {e.text}") from e
            return {"migrated_pages": pages}

        run_off_executor(cntl, push, "kvmig_pushto")
        return None

    def stats(self) -> dict:
        with self._mu:
            inbound = {s: dict(r) for s, r in self.inbound.items()}
        return {"store": self.store.name, "model": self.model,
                "model_refusals": self.n_model_refusals,
                "inbound": inbound}


def register_migration(server, store,
                       migrator: Optional[PageMigrator] = None,
                       model: str = "") -> MigrateService:
    """Expose `store` as a migration destination (and PushTo source) on
    `server`, before ``server.start()``.  ``model`` tags the store's
    deployment on the model plane (see MigrateService)."""
    svc = MigrateService(store, migrator=migrator, model=model)
    server.add_service(svc)
    return svc


def make_prefix_fetcher(migrator: PageMigrator, self_addr: str,
                        model: Optional[str] = None):
    """The ``prefix_fetcher`` hook ``Serving.Generate`` calls on a cache
    miss: try each holder the caller named (skipping this replica) until
    one push lands; returns the pages fetched, 0 when every holder
    failed (the caller recomputes).  ``model`` tags every fetch (default:
    the migrator's tag), so an owner of another model refuses it."""
    self_addr = str(self_addr)

    def fetch(prompt, holders) -> int:
        for h in holders:
            h = str(h)
            if h == self_addr:
                continue
            try:
                pages = migrator.fetch(prompt, h, self_addr, model=model)
            except Exception:
                continue
            if pages:
                return pages
        return 0

    return fetch


def rebalance_pusher(timeout_ms: int = 10_000):
    """The default ``migrate_on_rebalance`` hook: when the
    prefix-affinity ring remaps a prefix from `old_ep` to `new_ep`, ask
    the old owner to ``PushTo`` its pages to the new one.  Returns the
    pages migrated; the balancer absorbs a failure."""
    from ..rpc.channel import Channel
    chans: dict[str, Channel] = {}
    mu = InstrumentedLock("migrate.rebalance")

    def hook(tokens, old_ep, new_ep) -> int:
        src = str(old_ep)
        with mu:
            ch = chans.get(src)
            if ch is None:
                ch = Channel(src, timeout_ms=timeout_ms)
                chans[src] = ch
        out = ch.call_sync(MIGRATE_SERVICE, "PushTo",
                           {"tokens": [int(t) for t in tokens],
                            "dest": str(new_ep)},
                           serializer="json", response_serializer="json")
        return int((out or {}).get("migrated_pages", 0))

    return hook
