"""Disaggregated prefill/decode and cross-process failover over the KV
migration plane.

Port of ``brpc_tpu/migrate/disagg.py``.

DISAGGREGATION.  Prefill and decode have opposite resource profiles
(compute-bound bursts against memory-bound streaming); splitting them
into processes smooths both.  The split is the migration plane applied
end to end:

  * :class:`PrefillReplica` (the prefill process) admits the prompt into
    its own store, runs the real model's prefill (``run_prefill``: the
    paged kernel once per layer) into its pages, commits them to its
    radix tree, and ships them to the decode process through a
    :class:`~brpc_tpu_torch.migrate.PageMigrator`;
  * the decode process splices them (``register_migration``) and runs
    only the decode loop: its engine's admission prefix-hits the
    migrated pages;
  * :class:`DisaggCoordinator` pairs the two over
    :class:`~brpc_tpu_torch.ici.dcn.DcnChannel`: one ``generate`` runs
    ``DisaggPrefill.Prefill`` on the prefill address, then streams
    ``Serving.Generate`` from the decode address, under one rpcz trace.

A failed migration is a RECOMPUTE FALLBACK, never a failure: the
decode-side admission misses, prefills the suffix itself, and the
generation completes bit-exact.

The reference's ``batcher=`` prefill path serves its token-id stand-in
stores; here ``batcher=`` without ``runner=`` raises (ROADMAP Queue 1
item 7, second half, brings that path).

FAILOVER.  :class:`StandbySync` wraps an engine-shaped ``submit`` (a
``DecodeEngine`` or an ``EngineSupervisor``) and write-ahead-streams to
a standby process:

  * each emitted token is appended to the standby BEFORE the consumer
    sees it, so the standby's record is a superset of what any client
    saw; the cursor advances only on an ack, so a transient failure
    heals with the next token;
  * the live radix state ships at page boundaries
    (``KVCacheStore(commit_live_pages=True)`` commits each page the
    moment its K/V is written) through the same migration splice;
  * on primary death the client calls :meth:`StandbyReplica.assume`
    (or the ``_standby`` service's streaming ``Assume``,
    :func:`assume_stream`) with ITS cursor: the standby replays the
    tokens the client missed, then resumes decode from
    ``prompt + emitted``, prefix-hitting the migrated pages.  Exactly
    once: a second assume is refused.
"""
from __future__ import annotations

import inspect
import itertools
import json
import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

from .. import errors, rpcz
from ..butil import stagetag
from ..butil.lockprof import InstrumentedLock
from ..ici.dcn import DcnChannel
from ..rpc.service import Service, method
from ..rpc.stream import StreamHandler
from . import _register_standby
from .plane import PageMigrator, register_migration, run_off_executor

STANDBY_SERVICE = "_standby"

_sids = itertools.count(1)


# ---------------------------------------------------------------------------
# disaggregated prefill/decode
# ---------------------------------------------------------------------------

class PrefillReplica:
    """The prefill process's role: admit and prefill against a local
    store with ``runner`` (a ``TransformerRunner`` bound to it), then
    ship the finished pages to the decode process."""

    def __init__(self, store, decode_addr: str, *, batcher=None,
                 runner=None, name: str = "prefill",
                 timeout_ms: int = 10_000):
        if runner is None:
            raise ValueError(
                "PrefillReplica needs runner= (a TransformerRunner on the "
                "store): the batcher= prefill path is not ported yet "
                "(ROADMAP Queue 1 item 7, second half)")
        self.store = store
        self.decode_addr = decode_addr
        self.runner = runner
        self.name = name
        self.migrator = PageMigrator(store, name=f"{name}_migrator",
                                     timeout_ms=timeout_ms)
        self.prefills = 0
        self.fallbacks = 0
        self._mu = InstrumentedLock("migrate.prefill")

    def prefill(self, prompt: Sequence[int]) -> dict:
        """Run one prompt's prefill and ship its pages.  Returns the
        hand-off record the coordinator forwards: the emitted-prompt
        cursor, the local prefix hit, the pages migrated, and whether the
        decode side must recompute (the migration failed)."""
        from ..models.runner import run_prefill
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise errors.RpcError(errors.EREQUEST, "empty prompt")
        with stagetag.stage("prefill"):
            seq = self.store.admit(prompt)
            hit = seq.prefix_hit_tokens
            try:
                run_prefill(self.runner, seq, prompt)
            except Exception as e:
                self.store.retire(seq, cache=False)
                if isinstance(e, errors.RpcError):
                    raise
                raise errors.RpcError(errors.EINTERNAL,
                                      f"model prefill failed: "
                                      f"{type(e).__name__}: {e}")
            # the prompt's full pages become radix state to export
            self.store.retire(seq, cache=True)
        migrated, fallback = 0, False
        try:
            migrated = self.migrator.migrate(prompt, self.decode_addr)
        except errors.RpcError:
            # the decode side's admission misses and prefills itself
            fallback = True
        with self._mu:
            self.prefills += 1
            if fallback:
                self.fallbacks += 1
        return {"cursor": len(prompt), "prefix_hit": hit,
                "migrated_pages": migrated,
                "recompute_fallback": fallback}

    def stats(self) -> dict:
        with self._mu:
            return {"prefills": self.prefills,
                    "fallbacks": self.fallbacks,
                    "decode_addr": self.decode_addr}


class DisaggPrefillService(Service):
    NAME = "DisaggPrefill"

    def __init__(self, replica: PrefillReplica):
        self._replica = replica

    @method(request="json", response="json")
    def Prefill(self, cntl, req):
        prompt = (req or {}).get("prompt")
        if not prompt:
            cntl.set_failed(errors.EREQUEST, 'missing "prompt"')
            return None
        # the prefill waits on the decode side's OfferT
        run_off_executor(cntl, lambda: self._replica.prefill(prompt),
                         "disagg_prefill")
        return None


def register_disagg_prefill(server, store, decode_addr: str, *,
                            batcher=None, runner=None,
                            name: str = "prefill",
                            timeout_ms: int = 10_000) -> PrefillReplica:
    """Stand up the PREFILL role on `server`: ``DisaggPrefill`` over a
    PrefillReplica shipping pages to `decode_addr`."""
    replica = PrefillReplica(store, decode_addr, batcher=batcher,
                             runner=runner, name=name,
                             timeout_ms=timeout_ms)
    server.add_service(DisaggPrefillService(replica))
    return replica


def register_disagg_decode(server, store, engine):
    """Stand up the DECODE role on `server`: the migration splice (pages
    from prefill replicas land in `store`) and ``Serving.Generate`` over
    `engine`, whose admission prefix-hits the migrated pages."""
    from ..serving.service import register_serving
    svc = register_migration(server, store)
    register_serving(server, engine=engine)
    return svc


class _TokenCollector(StreamHandler):
    """Client stream handler: parses ``{"token": t}`` / ``{"done"}``
    messages, forwards tokens, latches the terminal."""

    def __init__(self, emit: Optional[Callable[[int], None]] = None):
        self.tokens: list[int] = []
        self.error: Optional[int] = None
        self.done = threading.Event()
        self._emit = emit
        self._terminal_seen = False

    def on_received_messages(self, stream, messages):
        for m in messages:
            try:
                d = json.loads(m)
            except ValueError:
                continue
            if "token" in d:
                t = int(d["token"])
                self.tokens.append(t)
                if self._emit is not None:
                    self._emit(t)
            if d.get("done"):
                self._terminal_seen = True
                if d.get("error"):
                    self.error = int(d["error"])
                self.done.set()

    def on_closed(self, stream):
        if not self._terminal_seen:
            # closed before the terminal: a TRUNCATED stream, never a
            # completed generation
            self.error = errors.EFAILEDSOCKET
        self.done.set()

    def on_idle_timeout(self, stream):
        pass


class DisaggCoordinator:
    """Pairs one prefill process and one decode process over DcnChannel
    and drives generations across the split.  ``device`` is what this
    side's handshake reports (default ``cuda``)."""

    def __init__(self, prefill_addr: str, decode_addr: str, *,
                 timeout_ms: int = 20_000, device=None):
        self.prefill = DcnChannel(prefill_addr, timeout_ms=timeout_ms,
                                  device=device)
        self.decode = DcnChannel(decode_addr, timeout_ms=timeout_ms,
                                 device=device)
        self.timeout_ms = int(timeout_ms)

    def pair(self) -> tuple:
        """Handshake both roles (idempotent); returns their topologies."""
        return self.prefill.handshake(), self.decode.handshake()

    def generate(self, prompt: Sequence[int], max_new_tokens: int, *,
                 emit: Optional[Callable[[int], None]] = None,
                 timeout_s: float = 60.0) -> dict:
        """One generation across the split: Prefill on the prefill
        process (its pages ship to the decode store), then tokens from
        ``Serving.Generate`` on the decode process.  Returns
        ``{"tokens", "prefill", "error", "prefix_hit", "prefill_ms"}``:
        the decode side's prefix hit and the Prefill call's
        client-timed milliseconds."""
        from ..rpc import Controller, stream_create
        prompt = [int(t) for t in prompt]
        span = rpcz.child_span("client", "Disagg", "Generate")
        prev = rpcz.get_current_span()
        if span is not rpcz.NULL_SPAN:
            rpcz.set_current_span(span)
        try:
            t0 = time.perf_counter()
            info = self.prefill.channel.call_sync(
                "DisaggPrefill", "Prefill", {"prompt": prompt},
                serializer="json", response_serializer="json")
            prefill_ms = 1e3 * (time.perf_counter() - t0)
            span.annotate(
                f"prefill handoff: cursor={info.get('cursor')} "
                f"migrated_pages={info.get('migrated_pages')} "
                f"fallback={info.get('recompute_fallback')}")
            col = _TokenCollector(emit)
            cntl = Controller(timeout_ms=self.timeout_ms)
            stream_create(cntl, col)
            resp = self.decode.channel.call_sync(
                "Serving", "Generate",
                {"prompt": prompt, "max_new_tokens": int(max_new_tokens)},
                serializer="json", cntl=cntl)
            if not col.done.wait(timeout_s):
                raise errors.RpcError(errors.ERPCTIMEDOUT,
                                      "decode stream never finished")
            span.annotate(f"decoded {len(col.tokens)} tokens"
                          + (f" err={col.error}" if col.error else ""))
            if col.error:
                span.error_code = col.error
            return {"tokens": col.tokens, "prefill": info,
                    "error": col.error,
                    "prefix_hit": int((resp or {}).get("prefix_hit", 0)),
                    "prefill_ms": prefill_ms}
        except errors.RpcError as e:
            span.error_code = e.code
            raise
        finally:
            if span is not rpcz.NULL_SPAN:
                rpcz.set_current_span(prev)
            rpcz.submit(span)


# ---------------------------------------------------------------------------
# cross-process failover
# ---------------------------------------------------------------------------

class _StandbyGen:
    """One replicated generation on the standby: the write-ahead token
    record plus the assume-once guard."""

    __slots__ = ("sid", "prompt", "budget", "emitted", "finished",
                 "error_code", "assumed", "trace", "mu")

    def __init__(self, sid: int, prompt, budget: int, trace):
        self.sid = sid
        self.prompt = [int(t) for t in prompt]
        self.budget = int(budget)
        self.emitted: list[int] = []
        self.finished = False
        self.error_code = 0
        self.assumed = False
        self.trace = trace          # (trace_id, parent_span_id, sampled)
        self.mu = InstrumentedLock("migrate.standby_gen")


def _takes_trace_ctx(submit) -> bool:
    try:
        return "trace_ctx" in inspect.signature(submit).parameters
    except (TypeError, ValueError):
        return False


class StandbyReplica:
    """The standby process's role: hold each replicated generation's
    write-ahead record (prompt, budget, emitted tokens) beside a store
    the migration splice keeps warm, and on ``assume`` complete the
    generation exactly once from the caller's cursor."""

    def __init__(self, store, engine, *, name: str = "standby"):
        self.store = store
        self.engine = engine
        self.name = name
        self._mu = InstrumentedLock("migrate.standby")
        self._gens: dict[int, _StandbyGen] = {}
        self.assumed_total = 0
        self.replayed_tokens = 0
        self.resumed_tokens = 0
        _register_standby(self)

    # ---- the write-ahead record (driven by the primary's sync) ----

    def begin(self, sid: int, prompt, budget: int,
              trace: tuple = (0, 0, True)) -> None:
        with self._mu:
            if sid not in self._gens:
                self._gens[sid] = _StandbyGen(sid, prompt, budget, trace)

    def _gen(self, sid: int) -> _StandbyGen:
        with self._mu:
            g = self._gens.get(sid)
        if g is None:
            raise errors.RpcError(errors.EREQUEST,
                                  f"no standby record for sid {sid}")
        return g

    def append(self, sid: int, cursor: int, toks: Sequence[int]) -> int:
        """Write-ahead append: `toks` start at position `cursor` of the
        emitted stream.  An overlap keeps the first copy (retries are
        idempotent); a GAP is refused, so the record stays a prefix of
        the true stream.  Returns the new cursor."""
        g = self._gen(sid)
        with g.mu:
            have = len(g.emitted)
            if cursor > have:
                raise errors.RpcError(
                    errors.EREQUEST,
                    f"append gap: cursor {cursor} but only {have} tokens "
                    f"recorded")
            g.emitted.extend(int(t) for t in list(toks)[have - cursor:])
            return len(g.emitted)

    def finish(self, sid: int, error_code: int = 0) -> None:
        with self._mu:
            g = self._gens.get(sid)
        if g is not None:
            with g.mu:
                g.finished = True
                g.error_code = int(error_code)

    # ---- failover ----

    def assume(self, sid: int, client_cursor: int,
               emit: Callable[[int], None],
               on_done: Optional[Callable] = None) -> dict:
        """Complete generation `sid` from the CLIENT's cursor: replay the
        recorded tokens the client never received, then resume decode
        from ``prompt + emitted`` on the local engine (admission
        prefix-hits the migrated pages).  A generation is assumed once.
        Returns ``{"replayed", "remaining", "resume_prefix_hit"}``; the
        terminal arrives through ``on_done(err)``."""
        g = self._gen(sid)
        with g.mu:
            if g.assumed:
                raise errors.RpcError(
                    errors.EREQUEST,
                    f"sid {sid} already assumed (exactly-once)")
            g.assumed = True
            emitted = list(g.emitted)
            finished, err_code = g.finished, g.error_code
            tid, psid, smp = g.trace
        if client_cursor < 0 or client_cursor > len(emitted):
            raise errors.RpcError(
                errors.EREQUEST,
                f"client cursor {client_cursor} outside the recorded "
                f"stream ({len(emitted)} tokens)")
        replayed = len(emitted) - client_cursor
        with self._mu:
            self.assumed_total += 1
            self.replayed_tokens += replayed
        # the attempt joins the generation's trace, like a supervisor
        # re-admission
        span = rpcz.new_span("generation", "Standby", self.name,
                             trace_id=tid, parent_span_id=psid,
                             sampled=smp if tid else None)
        span.annotate(f"standby assume: sid={sid} client_cursor="
                      f"{client_cursor} recorded={len(emitted)} replaying "
                      f"{replayed}")
        for t in emitted[client_cursor:]:
            emit(t)
        remaining = g.budget - len(emitted)
        if finished or remaining <= 0:
            err = None if not err_code else errors.RpcError(
                err_code, "primary recorded a failed terminal")
            span.annotate("nothing left to decode")
            rpcz.submit(span)
            if on_done is not None:
                on_done(err)
            return {"replayed": replayed, "remaining": 0}
        resume_prompt = g.prompt + emitted
        hit = int(self.store.probe(resume_prompt))
        span.annotate(f"resuming decode: {remaining} tokens from cursor "
                      f"{len(emitted)}; migrated prefix hit covers {hit}/"
                      f"{len(resume_prompt)} resume tokens")
        with self._mu:
            self.resumed_tokens += remaining

        def wrapped_emit(t: int) -> None:
            with g.mu:
                g.emitted.append(int(t))
            emit(t)

        def wrapped_done(err) -> None:
            with g.mu:
                g.finished = True
                g.error_code = err.code if err is not None else 0
            if err is not None:
                span.error_code = err.code
            rpcz.submit(span)
            if on_done is not None:
                on_done(err)

        kw = {}
        if _takes_trace_ctx(self.engine.submit):
            # a supervisor's submit takes none: the attempt span still
            # brackets the resume
            kw["trace_ctx"] = (span.trace_id, span.span_id, span.sampled)
        self.engine.submit(resume_prompt, remaining, wrapped_emit,
                           wrapped_done, **kw)
        return {"replayed": replayed, "remaining": remaining,
                "resume_prefix_hit": hit}

    def stats(self) -> dict:
        with self._mu:
            gens = list(self._gens.values())
            return {
                "live_records": sum(1 for g in gens if not g.finished),
                "records": len(gens),
                "assumed": self.assumed_total,
                "replayed_tokens": self.replayed_tokens,
                "resumed_tokens": self.resumed_tokens,
            }


class StandbyService(Service):
    """RPC surface of a StandbyReplica: Begin/Append/Finish feed the
    write-ahead record; the streaming Assume completes a generation for
    a failed-over client."""

    NAME = STANDBY_SERVICE

    def __init__(self, replica: StandbyReplica):
        self._replica = replica

    @method(request="json", response="json")
    def Begin(self, cntl, req):
        req = req or {}
        try:
            trace = tuple(req.get("trace") or (0, 0, True))
            self._replica.begin(int(req["sid"]), req.get("prompt") or [],
                                int(req.get("budget", 0)), trace)
        except (KeyError, TypeError, ValueError) as e:
            cntl.set_failed(errors.EREQUEST, f"bad Begin: {e}")
            return None
        return {"ok": True}

    @method(request="json", response="json")
    def Append(self, cntl, req):
        req = req or {}
        try:
            cur = self._replica.append(int(req["sid"]),
                                       int(req.get("cursor", 0)),
                                       req.get("toks") or [])
        except errors.RpcError as e:
            cntl.set_failed(e.code, e.text)
            return None
        except (KeyError, TypeError, ValueError) as e:
            cntl.set_failed(errors.EREQUEST, f"bad Append: {e}")
            return None
        return {"cursor": cur}

    @method(request="json", response="json")
    def Finish(self, cntl, req):
        req = req or {}
        try:
            self._replica.finish(int(req["sid"]), int(req.get("error", 0)))
        except (KeyError, TypeError, ValueError) as e:
            cntl.set_failed(errors.EREQUEST, f"bad Finish: {e}")
            return None
        return {"ok": True}

    @method(request="json", response="json")
    def Assume(self, cntl, req):
        req = req or {}
        stream = cntl.accept_stream()

        def emit(tok: int) -> None:
            stream.write(json.dumps({"token": tok}).encode(), timeout_s=2.0)

        def on_done(err) -> None:
            msg = {"done": True}
            if err is not None:
                msg["error"] = err.code
                msg["error_text"] = err.text
            try:
                stream.write(json.dumps(msg).encode(), timeout_s=2.0)
            except errors.RpcError:
                pass
            stream.close()

        try:
            info = self._replica.assume(int(req["sid"]),
                                        int(req.get("cursor", 0)),
                                        emit, on_done)
        except errors.RpcError as e:
            cntl.set_failed(e.code, e.text)
            return None
        except (KeyError, TypeError, ValueError) as e:
            cntl.set_failed(errors.EREQUEST, f"bad Assume: {e}")
            return None
        return {"accepted": True, **info}


def register_standby(server, store, engine, *,
                     name: str = "standby") -> StandbyReplica:
    """Stand up the STANDBY role on `server`: the migration splice (the
    primary's page stream lands in `store`) and the ``_standby``
    write-ahead/assume service over `engine`."""
    replica = StandbyReplica(store, engine, name=name)
    register_migration(server, store)
    server.add_service(StandbyService(replica))
    return replica


def assume_stream(standby_addr: str, sid: int, client_cursor: int, *,
                  emit: Optional[Callable[[int], None]] = None,
                  timeout_s: float = 60.0,
                  timeout_ms: int = 20_000) -> dict:
    """The failed-over client: call the standby's streaming ``Assume``
    and collect the completed tail.  Returns
    ``{"tokens", "error", ...info}``."""
    from ..rpc import Channel, Controller, stream_create
    ch = Channel(standby_addr, timeout_ms=timeout_ms)
    col = _TokenCollector(emit)
    cntl = Controller(timeout_ms=timeout_ms)
    stream_create(cntl, col)
    info = ch.call_sync(STANDBY_SERVICE, "Assume",
                        {"sid": int(sid), "cursor": int(client_cursor)},
                        serializer="json", cntl=cntl)
    if not col.done.wait(timeout_s):
        raise errors.RpcError(errors.ERPCTIMEDOUT,
                              "standby assume stream never finished")
    return {"tokens": col.tokens, "error": col.error, **(info or {})}


class StandbySync:
    """Primary-side replication: wraps an engine-shaped ``submit`` so
    every generation's tokens write-ahead-stream to a standby process
    and its live pages ship at page boundaries (see the module
    docstring).  Pair the primary's store with
    ``commit_live_pages=True``."""

    # terminal codes that mean THE PRIMARY broke, not the generation:
    # the standby record stays open for the client's assume
    FAILOVER_CODES = (errors.ELOGOFF, errors.EINTERNAL)

    def __init__(self, store, standby_addr: str, *, submit_fn: Callable,
                 name: str = "standby_sync", timeout_ms: int = 10_000):
        self.store = store
        self.standby_addr = standby_addr
        self.submit_fn = submit_fn
        self.name = name
        # the control RPCs ride the connection the handshake pairs
        self._ch = DcnChannel(standby_addr, timeout_ms=timeout_ms,
                              device=store.device)
        self.migrator = PageMigrator(store, name=f"{name}_migrator",
                                     timeout_ms=timeout_ms)
        self._mu = InstrumentedLock("migrate.standby_sync")
        self._toks: dict[int, list[int]] = {}     # sid -> prompt+emitted
        self._shipped: dict[int, int] = {}        # sid -> full pages sent
        self._traces: dict[int, tuple] = {}
        self.sync_errors = 0
        self.ship_errors = 0
        self.synced_tokens = 0
        self.shipped_pages = 0
        # one ship worker: page exports must not ride the emit path;
        # jobs coalesce per sid to the newest prefix
        self._ship_cv = threading.Condition(InstrumentedLock("migrate.ship"))
        self._ship_q: deque[int] = deque()
        self._ship_pending: set[int] = set()
        self._ship_inflight = 0
        self._running = True
        self._ship_thread = threading.Thread(
            target=self._ship_loop, daemon=True, name=f"kv-migrate-{name}")
        self._ship_thread.start()

    def _call(self, method_name: str, body: dict):
        return self._ch.channel.call_sync(
            STANDBY_SERVICE, method_name, body, serializer="json",
            response_serializer="json")

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               emit: Callable[[int], None],
               on_done: Optional[Callable] = None) -> int:
        """Engine-shaped submit with standby replication.  Returns the
        standby sid, the key of a failed-over client's ``Assume``."""
        prompt = [int(t) for t in prompt]
        sid = next(_sids)
        trace = rpcz.current_trace_ctx()
        with self._mu:
            self._toks[sid] = list(prompt)
            self._shipped[sid] = 0
            self._traces[sid] = trace
        # synchronous and unconditional: a standby that never heard of a
        # sid cannot replay it
        self._call("Begin", {"sid": sid, "prompt": prompt,
                             "budget": int(max_new_tokens),
                             "trace": list(trace)})
        self._enqueue_ship(sid)
        state_mu = InstrumentedLock("migrate.sync_state")
        synced = [0]               # tokens the standby acked
        pending: list[int] = []    # emitted, not yet acked

        def wrapped_emit(tok: int) -> None:
            tok = int(tok)
            with state_mu:
                pending.append(tok)
                cur = synced[0]
                batch = list(pending)
            try:
                self._call("Append", {"sid": sid, "cursor": cur,
                                      "toks": batch})
                with state_mu:
                    synced[0] = cur + len(batch)
                    del pending[:len(batch)]
                with self._mu:
                    self.synced_tokens += len(batch)
            except errors.RpcError:
                # degraded (a failover now replays up to the last acked
                # cursor); the tail retries with the next token
                with self._mu:
                    self.sync_errors += 1
            boundary = False
            with self._mu:
                toks = self._toks.get(sid)
                if toks is not None:
                    toks.append(tok)
                    boundary = (len(toks) // self.store.page_tokens
                                > self._shipped.get(sid, 0))
            if boundary:
                self._enqueue_ship(sid)
            emit(tok)

        def wrapped_done(err) -> None:
            code = err.code if err is not None else 0
            if code not in self.FAILOVER_CODES:
                # a real terminal: close the standby record
                try:
                    self._call("Finish", {"sid": sid, "error": code})
                except errors.RpcError:
                    with self._mu:
                        self.sync_errors += 1
                with self._mu:
                    self._toks.pop(sid, None)
                    self._shipped.pop(sid, None)
                    self._traces.pop(sid, None)
            if on_done is not None:
                on_done(err)

        self.submit_fn(prompt, int(max_new_tokens), wrapped_emit,
                       wrapped_done)
        return sid

    # ---- incremental page shipping ----

    def _enqueue_ship(self, sid: int) -> None:
        with self._ship_cv:
            if sid not in self._ship_pending:
                self._ship_pending.add(sid)
                self._ship_q.append(sid)
                self._ship_cv.notify()

    def _ship_loop(self) -> None:
        while True:
            with self._ship_cv:
                while self._running and not self._ship_q:
                    self._ship_cv.wait(0.25)
                if not self._running:
                    return
                sid = self._ship_q.popleft()
                self._ship_pending.discard(sid)
                self._ship_inflight += 1
            try:
                self._ship_one(sid)
            finally:
                with self._ship_cv:
                    self._ship_inflight -= 1
                    self._ship_cv.notify_all()

    def _ship_one(self, sid: int) -> None:
        with self._mu:
            toks = list(self._toks.get(sid) or ())
            shipped = self._shipped.get(sid, 0)
            trace = self._traces.get(sid, (0, 0, True))
        if len(toks) // self.store.page_tokens <= shipped:
            return
        try:
            pages = self.migrator.migrate(toks, self.standby_addr,
                                          trace_ctx=trace)
            with self._mu:
                if sid in self._shipped:
                    self._shipped[sid] = max(self._shipped[sid], pages)
                self.shipped_pages += pages
        except errors.RpcError:
            # the standby recomputes whatever never arrived
            with self._mu:
                self.ship_errors += 1

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Drain the ship queue, the job in flight included."""
        deadline = time.monotonic() + timeout_s
        with self._ship_cv:
            while self._ship_q or self._ship_pending or self._ship_inflight:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return False
                self._ship_cv.wait(min(rem, 0.25))
            return True

    def close(self) -> None:
        with self._ship_cv:
            self._running = False
            self._ship_cv.notify_all()
        self._ship_thread.join(5.0)

    def stats(self) -> dict:
        with self._mu:
            return {
                "standby_addr": self.standby_addr,
                "live": len(self._toks),
                "synced_tokens": self.synced_tokens,
                "shipped_pages": self.shipped_pages,
                "sync_errors": self.sync_errors,
                "ship_errors": self.ship_errors,
            }
