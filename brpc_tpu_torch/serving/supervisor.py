"""EngineSupervisor: crash recovery and overload degradation for the
decode engine (a copy of ``brpc_tpu/serving/supervisor.py``).

If the DecodeEngine's step loop crashes or wedges mid-decode, every
in-flight generation would be lost, though its KV pages sit safely in a
KVCacheStore that outlives the engine.  The supervisor closes that gap:

WATCHDOG.  The engine publishes a heartbeat every loop iteration.  The
supervisor flags a failure when (a) the engine's crash handler fires (a
step or verify exception, e.g. the ``serving.step`` fault site), (b)
the loop thread has died, or (c) work is pending but the heartbeat has
not advanced within ``heartbeat_deadline_s`` -- a WEDGED loop (the
``serving.heartbeat`` fault site suppresses beats while the loop runs).

RECOVERY.  The supervisor takes the engine's slots and waiters over
WITHOUT finishing them, re-attaches each in-flight sequence's committed
full pages to the radix tree under a recovery pin
(``KVCacheStore.detach``: eviction cannot free the prefix before the
re-admission), tears the engine down, rebuilds one against the SAME
store, and re-admits every request from its last emitted token: the
resume prompt is ``prompt + emitted``, so admission hits the committed
pages and only the uncommitted tail re-decodes.  Emission stays
exactly-once across the seam: the per-request CURSOR advances only when
a token reaches the consumer, tokens buffered at the crash flush
through the old emitter before the restart marker, and the resumed
decode starts after the cursor.  After ``max_restarts`` crashes inside
``restart_window_s`` the supervisor stops rebuilding and fails pending
requests definitively.

DEGRADATION LADDER.  Each watchdog tick reads the batcher's queue-delay
p99, the engine's queue depth and the page pool's occupancy, and maps
them onto levels (``serving/ladder.py``): 1 sheds the batcher's
lowest lane (deadline-less requests), 2 also clamps ``max_new_tokens``
of new submissions, 3 also evicts cached pages each tick.  Up at once,
down one level per ``hysteresis_ticks`` calm ticks.

TRACING.  A supervised generation is one rpcz trace: the trace context
is captured at ``submit`` (the RPC server's span), and each engine
attempt gets a ``generation`` span in it; a post-crash attempt links its
predecessor through ``recovered_from`` and annotates the resume cursor
and the re-decoded tokens, and the pre-crash decode span closes at the
takeover with ELOGOFF.  The engine's decode and prefill spans nest
under the attempt's span.  The state, engine hand-off and per-request
locks are named (``supervisor.*``).

FLAPPING REPLICAS.  Every crash is reported to the port's circuit
breaker (``policy/circuit_breaker.py``): its isolation count for the
supervisor's ``endpoint`` grows by one per crash, so holds double, and
once ``quarantine_after`` crashes accumulate inside
``restart_window_s`` the endpoint is marked broken with the breaker's
isolation hold.  Balancers (``prefix_affinity`` too) stop selecting it,
so the consistent-hash ring remaps only the quarantined replica's share
of prefixes, until the health check's probe revives it.  The report
runs outside the supervisor's locks.

``submit`` has the DecodeEngine's signature, so a supervisor drops into
``register_serving(engine=...)`` unchanged.  The engine and the batcher
compute on their own devices; the supervisor runs on the host.
"""
from __future__ import annotations

import itertools
import logging
import re
import threading
import time
from typing import Callable, Optional, Sequence

from .. import errors, rpcz
from ..butil.lockprof import InstrumentedLock
from ..bvar import Adder, PassiveStatus
from ..bvar.variable import exposed_variables, find_exposed
from .ladder import OverloadLadder

_log = logging.getLogger(__name__)
_sup_req_ids = itertools.count(1)

# default ladder thresholds per level (1..3): queue-delay p99 (us),
# page-pool occupancy ratio, engine queue depth per slot
DEFAULT_LADDER = (
    {"queue_delay_us": 50_000.0, "pool_ratio": 0.75, "queue_depth": 2.0},
    {"queue_delay_us": 100_000.0, "pool_ratio": 0.88, "queue_depth": 4.0},
    {"queue_delay_us": 200_000.0, "pool_ratio": 0.96, "queue_depth": 8.0},
)


class _SupReq:
    """One supervised generation: the original request plus the
    emitted-token cursor that makes recovery exactly-once."""

    __slots__ = ("sid", "prompt", "max_new_tokens", "user_emit",
                 "user_done", "emitted", "restarts", "finished", "pin",
                 "resumed", "trace", "attempt_span", "last_span_id",
                 "t_start", "mu", "delivery_mu", "speculative")

    def __init__(self, prompt, max_new_tokens, emit, on_done,
                 speculative: bool = True):
        self.sid = next(_sup_req_ids)
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.user_emit = emit
        self.user_done = on_done
        self.speculative = bool(speculative)   # sticky across restarts
        self.emitted: list[int] = []   # the exactly-once cursor
        self.restarts = 0
        self.finished = False
        self.pin = None                # RecoveryPin while re-admitting
        # the trace captured here stays across restarts, so every
        # attempt's span shares one trace_id; each links its predecessor
        self.trace = rpcz.current_trace_ctx()
        self.attempt_span = rpcz.NULL_SPAN   # the current attempt's
        self.last_span_id = 0                # the previous attempt's
        self.t_start = time.monotonic()
        # True between a re-admission and its first token: tells the NEW
        # engine's first token (recovery proven: release the pin, stamp
        # the time to recover) from pre-crash tokens still flushing out
        # of the old emitter
        self.resumed = False
        self.mu = InstrumentedLock("supervisor.request")
        # serialises token delivery against the terminal: user_done waits
        # for an in-flight user_emit, and no token follows it.  Never
        # held with `mu` during a user callback; always taken FIRST.
        self.delivery_mu = InstrumentedLock("supervisor.delivery")


class EngineSupervisor:
    """Watchdog + crash recovery + overload ladder for a DecodeEngine
    (see the module docstring).  ``engine_factory()`` builds an engine
    against ``store``."""

    def __init__(self, engine_factory: Callable, *,
                 store=None,
                 batcher=None,
                 heartbeat_deadline_s: float = 5.0,
                 check_interval_s: float = 0.1,
                 max_restarts: int = 8,
                 restart_window_s: float = 60.0,
                 quarantine_after: int = 3,
                 endpoint=None,
                 ladder: Sequence[dict] = DEFAULT_LADDER,
                 clamp_new_tokens: int = 32,
                 hysteresis_ticks: int = 5,
                 name: str = "supervisor"):
        self.engine_factory = engine_factory
        # CALLER-owned and shared across engine incarnations: the radix
        # tree outliving the engine is what makes recovery prefill-free
        self.store = store
        self.batcher = batcher
        self.heartbeat_deadline_s = float(heartbeat_deadline_s)
        self.check_interval_s = float(check_interval_s)
        self.max_restarts = int(max_restarts)
        self.restart_window_s = float(restart_window_s)
        self.quarantine_after = int(quarantine_after)
        self.endpoint = endpoint
        self.ladder = tuple(ladder)
        self.clamp_new_tokens = int(clamp_new_tokens)
        self.hysteresis_ticks = int(hysteresis_ticks)
        self.name = name

        self._ladder = OverloadLadder(self.ladder,
                                      hysteresis_ticks=self.hysteresis_ticks)
        self.state = "healthy"          # healthy|degraded|restarting|failed
        self.last_recovery: Optional[dict] = None
        self._restart_times: list[float] = []
        self._await_first_token_t: Optional[float] = None

        self._mu = InstrumentedLock("supervisor.state")
        self._live: dict[int, _SupReq] = {}      # sid -> request
        self._by_rid: dict[int, _SupReq] = {}    # engine req_id -> request
        self._closing = False
        self._failed = False

        safe = re.sub(r"\W", "_", name)
        pre = set(exposed_variables(f"serving_{safe}*"))
        self.restarts_total = Adder(f"serving_{safe}_restarts")
        self.readmitted = Adder(f"serving_{safe}_readmitted")
        self.resumed_tokens = Adder(f"serving_{safe}_resumed_tokens")
        self.ladder_evictions = Adder(f"serving_{safe}_ladder_evictions")
        PassiveStatus(lambda: self.level).expose(
            f"serving_{safe}_brownout_level")
        self._bvar_names = [n for n in exposed_variables(f"serving_{safe}*")
                            if n not in pre]

        # the engine hand-off: _engine is None while a rebuild is in
        # flight, and re-admissions wait on the condition
        self._ecv = threading.Condition(
            InstrumentedLock("supervisor.engine"))
        self._wake = threading.Event()
        self._running = True
        self._engine = self._build_engine()
        self._thread = threading.Thread(
            target=self._watchdog, daemon=True,
            name=f"serving-supervisor-{safe}")
        self._thread.start()
        from . import _register_supervisor
        _register_supervisor(self)

    # ---- engine lifecycle ----

    def _build_engine(self):
        eng = self.engine_factory()
        eng.set_crash_handler(self._on_engine_crash)
        eng.degraded_clamp = self.clamp_new_tokens if self.level >= 2 \
            else None
        return eng

    def _on_engine_crash(self, engine, exc) -> None:
        # runs on the dying engine thread: only signal the watchdog
        self._wake.set()

    def _engine_now(self, timeout_s: float = 30.0):
        """The current engine, waiting out a rebuild in flight."""
        deadline = time.monotonic() + timeout_s
        with self._ecv:
            while self._engine is None and not self._failed \
                    and not self._closing:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return None
                self._ecv.wait(rem)
            return self._engine

    @property
    def engine(self):
        return self._engine

    # ---- submission (DecodeEngine-compatible) ----

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               emit: Callable[[int], None],
               on_done: Optional[Callable] = None, *,
               speculative: bool = True) -> int:
        """DecodeEngine.submit's contract -- each token through ``emit``
        exactly once, across any number of engine restarts, then one
        ``on_done(err)`` -- plus re-admission if the engine dies
        mid-decode."""
        # the ladder's clamp is decided ONCE, here: the budget a request
        # is admitted with is the one it keeps through every restart
        if self.level >= 2:
            max_new_tokens = min(int(max_new_tokens),
                                 self.clamp_new_tokens)
        sreq = _SupReq(prompt, max_new_tokens, emit, on_done,
                       speculative=speculative)
        with self._mu:
            closing = self._closing or self._failed
            if not closing:
                self._live[sreq.sid] = sreq
        if closing:
            self._finish(sreq, errors.RpcError(
                errors.ELOGOFF, "supervisor closed"))
            return sreq.sid
        self._submit_to_engine(sreq)
        return sreq.sid

    def _submit_to_engine(self, sreq: _SupReq) -> bool:
        with sreq.mu:
            emitted = list(sreq.emitted)
        remaining = sreq.max_new_tokens - len(emitted)
        if remaining <= 0:
            # the whole budget was delivered before the crash
            self._finish(sreq, None)
            return True
        eng = self._engine_now()
        if eng is None:
            self._finish(sreq, errors.RpcError(
                errors.EINTERNAL,
                "supervisor gave up rebuilding the engine"))
            return False
        # resume prompt = original + emitted: admission hits the pages
        # detach() committed, and decode restarts from the exact (token,
        # position) the crashed loop would have used next
        resume_prompt = sreq.prompt + emitted
        ctx = self._open_attempt_span(sreq, resume_prompt, remaining,
                                      len(emitted))
        with sreq.mu:
            sreq.resumed = sreq.restarts > 0
        rid = eng.submit(resume_prompt, remaining,
                         lambda tok, s=sreq: self._emit(s, tok),
                         lambda err, s=sreq: self._req_done(s, err),
                         clamp=False, trace_ctx=ctx,
                         speculative=sreq.speculative)
        with self._mu:
            self._by_rid[rid] = sreq
        return True

    # ---- generation tracing ----

    def _open_attempt_span(self, sreq: _SupReq, resume_prompt,
                           remaining: int, cursor: int) -> tuple:
        """One ``generation`` span per engine attempt, all in the trace
        captured at submit (made stable by the first attempt); a
        post-crash attempt links its predecessor (``recovered_from``)
        and annotates the resume cursor and the re-decoded tokens.
        Returns the trace context for the engine, so the attempt's
        decode and prefill spans nest under it."""
        with sreq.mu:
            tid, psid, smp = sreq.trace
            restarts = sreq.restarts
            last_sid = sreq.last_span_id
        span = rpcz.new_span("generation", "Serving", self.name,
                             trace_id=tid, parent_span_id=psid,
                             sampled=smp if tid else None)
        if span is rpcz.NULL_SPAN:
            return (tid, psid, smp)
        if restarts:
            span.recovered_from = last_sid
            span.annotate(
                f"recovered_from=span {last_sid}: restart {restarts}, "
                f"resume_cursor={cursor} tokens already emitted, "
                f"{remaining} remaining")
            if self.store is not None:
                # the committed prefix the resume prompt hits (advisory
                # probe): the rest is what this recovery re-decodes
                hit = int(self.store.probe(resume_prompt))
                span.annotate(
                    f"re_decoded_tokens={len(resume_prompt) - hit} "
                    f"(committed prefix hit={hit} of "
                    f"{len(resume_prompt)})")
        with sreq.mu:
            sreq.attempt_span = span
            sreq.last_span_id = span.span_id
            if not tid:
                # the first attempt rooted the trace: later attempts
                # must reuse it
                sreq.trace = (span.trace_id, psid, span.sampled)
        return (span.trace_id, span.span_id, span.sampled)

    def _close_attempt_span(self, sreq: _SupReq, err,
                            note: Optional[str] = None) -> None:
        """Submit the current attempt's span exactly once (the swap to
        NULL_SPAN under the lock is the guard)."""
        with sreq.mu:
            span, sreq.attempt_span = sreq.attempt_span, rpcz.NULL_SPAN
        if span is rpcz.NULL_SPAN:
            return
        if err is not None:
            span.error_code = err.code
        if note:
            span.annotate(note)
        rpcz.submit(span)

    # ---- per-request plumbing ----

    def _emit(self, sreq: _SupReq, tok: int) -> None:
        with sreq.delivery_mu:
            with sreq.mu:
                if sreq.finished:
                    # the terminal went out already (close or give-up
                    # raced a flushing old emitter): no token after it
                    return
                sreq.emitted.append(tok)  # the cursor first
                first_resumed = sreq.resumed
                sreq.resumed = False
                pin = None
                aspan = rpcz.NULL_SPAN
                if first_resumed:
                    # from the REBUILT engine, whose admission holds its
                    # own refs: the recovery pin has done its job (a
                    # pre-crash token flushing from the old emitter
                    # proves nothing and keeps it held)
                    pin, sreq.pin = sreq.pin, None
                    aspan = sreq.attempt_span
            if pin is not None:
                pin.release()
            aspan.annotate("first post-recovery token delivered "
                           "(recovery pin released)")
            if first_resumed:
                t0 = self._await_first_token_t
                if t0 is not None:
                    self._await_first_token_t = None
                    if self.last_recovery is not None:
                        self.last_recovery["detect_to_first_token_ms"] \
                            = round((time.monotonic() - t0) * 1e3, 2)
            # delivered INSIDE delivery_mu: a concurrent _finish waits
            # for this write, so the terminal can never overtake it
            sreq.user_emit(tok)

    def _req_done(self, sreq: _SupReq, err) -> None:
        if err is not None and err.code == errors.ELOGOFF \
                and not self._closing and not self._failed:
            # the ENGINE died under this request: re-admit it after the
            # emitted cursor, within the restart budget
            with sreq.mu:
                sreq.restarts += 1
                give_up = sreq.restarts > self.max_restarts
                resumed = len(sreq.emitted)
            if not give_up:
                self._close_attempt_span(
                    sreq, err, "engine died mid-decode; re-admitting "
                    "after the emitted cursor")
                self.readmitted.add(1)
                self.resumed_tokens.add(resumed)
                self._submit_to_engine(sreq)
                return
        self._finish(sreq, err)

    def _finish(self, sreq: _SupReq, err) -> None:
        with sreq.delivery_mu:
            # delivery_mu FIRST (as in _emit) waits out an in-flight
            # token and fences later ones
            with sreq.mu:
                if sreq.finished:
                    return
                sreq.finished = True
                pin, sreq.pin = sreq.pin, None
            if pin is not None:
                pin.release()
            self._close_attempt_span(sreq, err)
            with sreq.mu:
                emitted = len(sreq.emitted)
                restarts = sreq.restarts
            from . import record_generation
            record_generation({
                "supervisor": self.name,
                "sid": sreq.sid,
                "trace_id": sreq.trace[0],
                "prompt_len": len(sreq.prompt),
                "emitted": emitted,
                "restarts": restarts,
                "duration_us": int((time.monotonic() - sreq.t_start) * 1e6),
                "error_code": err.code if err is not None else 0,
            })
            if sreq.user_done is not None:
                try:
                    sreq.user_done(err)
                except Exception:
                    _log.exception("supervised on_done callback raised")
            # live until its terminal is delivered: join_idle() returning
            # means every on_done has run (the JAX package drops the
            # request first, and a caller could see idle before its
            # last on_done)
            with self._mu:
                self._live.pop(sreq.sid, None)

    # ---- the watchdog ----

    def _watchdog(self) -> None:
        while True:
            self._wake.wait(self.check_interval_s)
            self._wake.clear()
            if not self._running:
                return
            eng = self._engine
            reason = None
            if eng is not None:
                if eng.crashed is not None:
                    reason = (f"step crash: {type(eng.crashed).__name__}: "
                              f"{eng.crashed}")
                elif not eng._thread.is_alive():
                    reason = "engine thread died"
                else:
                    _, beat_t = eng.heartbeat()
                    age = time.monotonic() - beat_t
                    if age > self.heartbeat_deadline_s and eng.has_work():
                        reason = (f"wedged step loop: no progress for "
                                  f"{age:.2f}s with work pending")
            try:
                if reason is not None:
                    self._recover(reason)
                if not self._running:
                    return
                self._update_degradation()
            except Exception:
                # the watchdog must survive its own bugs
                _log.exception("supervisor watchdog tick failed")

    # ---- crash recovery ----

    def _recover(self, reason: str) -> None:
        t_detect = time.monotonic()
        self.state = "restarting"
        self.restarts_total.add(1)
        self._restart_times.append(t_detect)
        self._restart_times = [t for t in self._restart_times
                               if t > t_detect - self.restart_window_s]
        gave_up = len(self._restart_times) > self.max_restarts
        if gave_up:
            # past the budget: the state reads "failed" before a stolen
            # request's terminal is delivered below, whose own restart
            # budget may end it first (on its emitter thread)
            self._mark_failed()
        old = self._engine
        with self._ecv:
            self._engine = None         # re-admissions park in _engine_now
        stolen, waiters = old.takeover()
        restart_err = errors.RpcError(
            errors.ELOGOFF, "engine restarting (supervisor takeover)")
        pinned = 0
        for slot in stolen:
            with self._mu:
                sreq = self._by_rid.pop(slot.req.req_id, None)
            if self.store is not None:
                try:
                    pin = self.store.detach(slot.seq)
                except Exception:
                    _log.exception("detach of a crashed sequence failed")
                    pin = None
                if pin is not None and len(pin):
                    pinned += 1
                    if sreq is not None:
                        with sreq.mu:
                            old_pin, sreq.pin = sreq.pin, pin
                            # a new recovery epoch: tokens buffered but
                            # not delivered are about to flush, and must
                            # not pass for the next engine's first token
                            sreq.resumed = False
                        if old_pin is not None:
                            old_pin.release()
                    else:
                        pin.release()   # nobody to re-admit
            # the pre-crash decode span ends HERE (the slot never retires
            # through the dead engine), inside the generation's trace
            if slot.span is not rpcz.NULL_SPAN:
                slot.span.error_code = errors.ELOGOFF
                slot.span.annotate(
                    f"engine takeover: {reason}; {slot.generated} "
                    f"tokens decoded pre-crash")
                rpcz.submit(slot.span)
            # the old emitter flushes every buffered token (the cursor
            # counts them: they are NOT re-decoded), then the restart
            # marker, whose _req_done re-admits the request; the
            # resubmission parks in _engine_now until the rebuild lands
            slot.req.buf.push_terminal(restart_err)
        with self._mu:
            # any rid not stolen (mid-admission) belongs to the dead
            # engine too; its ELOGOFF terminal re-admits it
            self._by_rid.clear()
        old.close(timeout_s=1.0)
        self._report_crash()
        if not gave_up:
            try:
                new = self._build_engine()
            except Exception as e:
                # a factory that cannot build strands every parked
                # re-admission: fail definitively instead
                gave_up = True
                reason = (f"{reason}; rebuild failed: "
                          f"{type(e).__name__}: {e}")
        if gave_up:
            self._fail_permanently(reason)
        else:
            # the record BEFORE the engine is published: a fast first
            # token must find _await_first_token_t in place
            self.last_recovery = {
                "reason": reason,
                "stolen_slots": len(stolen),
                "queued_waiters": len(waiters),
                "pinned_seqs": pinned,
                "detect_to_rebuild_ms": round(
                    (time.monotonic() - t_detect) * 1e3, 2),
            }
            self._await_first_token_t = t_detect
            with self._ecv:
                self._engine = new
                self._ecv.notify_all()
            self.state = "degraded" if self.level else "healthy"
        # the never-admitted waiters LAST: finish() runs the re-admission
        # on THIS thread, which must not park in _engine_now before the
        # rebuild above is published (it would be waiting on itself)
        for req in waiters:
            req.finish(restart_err)

    def _report_crash(self) -> None:
        """Feed the crash to the circuit breaker: the endpoint's
        isolation count grows by one (so its holds double), and past
        ``quarantine_after`` crashes in the window the endpoint is marked
        broken, which every balancer skips until the probe revives it."""
        if self.endpoint is None:
            return
        try:
            from ..policy.circuit_breaker import global_breaker
            breaker = global_breaker()
            breaker.on_socket_failed(self.endpoint)   # isolation count +1
            if len(self._restart_times) >= self.quarantine_after:
                breaker.mark_as_broken(self.endpoint)
        except Exception:
            _log.exception("supervisor crash report failed")

    def _mark_failed(self) -> None:
        self.state = "failed"
        with self._ecv:
            self._failed = True
            self._ecv.notify_all()

    def _fail_permanently(self, reason: str) -> None:
        """Too many crashes inside the window: stop rebuilding, and give
        every pending request a definite error.  The state reads
        "failed" before any parked re-admission wakes to its error, so a
        caller that got the error sees it (the JAX package publishes the
        state after the wake-up)."""
        self._mark_failed()
        err = errors.RpcError(
            errors.EINTERNAL,
            f"engine supervisor gave up after "
            f"{len(self._restart_times)} restarts in "
            f"{self.restart_window_s:.0f}s: {reason}")
        with self._mu:
            live = list(self._live.values())
        for sreq in live:
            self._finish(sreq, err)

    # ---- the degradation ladder ----

    def _pressures(self) -> dict:
        q_us = 0.0
        if self.batcher is not None:
            try:
                q_us = float(
                    self.batcher.queue_delay_rec.latency_percentile(0.99))
            except Exception:
                q_us = 0.0
        pool = 0.0
        if self.store is not None:
            try:
                pool = self.store.pool_ratio()
            except Exception:
                pool = 0.0
        depth = 0.0
        eng = self._engine
        if eng is not None:
            try:
                depth = eng.queue_depth()
            except Exception:
                depth = 0.0
        return {"queue_delay_us": q_us, "pool_ratio": pool,
                "queue_depth": depth}

    @property
    def level(self) -> int:
        """The current degradation level."""
        return self._ladder.level

    def set_level_floor(self, floor: int) -> None:
        """Hold this replica at a minimum level whatever its local
        pressures; applied on the next watchdog tick (or at once by an
        explicit ``_update_degradation``)."""
        self._ladder.floor = max(0, min(int(floor), len(self.ladder)))

    def _update_degradation(self) -> None:
        self._ladder.update(self._pressures())
        self._apply_level()
        if self.state in ("healthy", "degraded"):
            self.state = "degraded" if self.level else "healthy"

    def _apply_level(self) -> None:
        lvl = self.level
        if self.batcher is not None:
            self.batcher.brownout = lvl
        eng = self._engine
        if eng is not None:
            eng.degraded_clamp = self.clamp_new_tokens if lvl >= 2 \
                else None
        if lvl >= 3 and self.store is not None:
            # a block's worth of cached pages per tick
            freed = self.store.evict_pages(
                self.store.pagepool.pages_per_block)
            if freed:
                self.ladder_evictions.add(freed)

    # ---- lifecycle / introspection ----

    def join_idle(self, timeout_s: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._mu:
                if not self._live:
                    return True
            time.sleep(0.005)
        return False

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop supervising and close the engine; pending requests
        finish with ELOGOFF (passed through: a closing supervisor does
        not re-admit).  The KV store stays up, caller-owned."""
        self._closing = True
        self._running = False
        self._wake.set()
        self._thread.join(timeout_s)
        # undo the ladder's effect on the CALLER-owned batcher: nothing
        # would de-escalate it any more
        if self.batcher is not None:
            self.batcher.brownout = 0
        eng = self._engine
        with self._ecv:
            self._engine = None
            self._ecv.notify_all()
        if eng is not None:
            eng.close(timeout_s)
        # anything the engine close missed (e.g. mid-resubmission)
        err = errors.RpcError(errors.ELOGOFF, "supervisor closed")
        with self._mu:
            live = list(self._live.values())
        for sreq in live:
            self._finish(sreq, err)
        for n in self._bvar_names:
            v = find_exposed(n)
            if v is not None:
                v.hide()

    def stats(self) -> dict:
        with self._mu:
            live = len(self._live)
        eng = self._engine
        quarantined = False
        if self.endpoint is not None:
            from ..policy.health_check import is_broken
            quarantined = is_broken(self.endpoint)
        out = {
            "state": self.state,
            "degradation_level": self.level,
            "restarts": self.restarts_total.get_value(),
            "readmitted": self.readmitted.get_value(),
            "resumed_tokens": self.resumed_tokens.get_value(),
            "ladder_evictions": self.ladder_evictions.get_value(),
            "live_requests": live,
            "ladder": self._ladder.stats(),
            "engine": None if eng is None else eng.name,
            "heartbeat_deadline_s": self.heartbeat_deadline_s,
            "last_recovery": self.last_recovery,
            "quarantined": quarantined,
        }
        if self.endpoint is not None:
            out["endpoint"] = str(self.endpoint)
        return out
