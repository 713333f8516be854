"""Continuous-batching decode engine over the paged KV cache.

Port of the plain (non-speculative) path of
``brpc_tpu/serving/engine.py``.  A fixed pool of decode slots steps
together through ONE runner call per iteration; requests join at step
boundaries with a free slot and leave when done, and each generated
token streams to its caller per step.

  * admission: ``store.admit`` serves the prompt's longest cached prefix
    from shared pages; the runner prefills only the bucket-padded
    suffix, writing its K/V into the pages;
  * the step: fixed-shape ``tokens``/``positions`` ``[num_slots]`` plus
    the gathered page tables ``[num_slots, max_pages_per_slot]`` go to
    ``runner.step``; the returned K/V rows land in the pages in ONE
    batched write (``store.write_kv_batch``), then each sequence extends
    by its new token;
  * emission: each request has a bounded emit buffer drained by its own
    emitter thread, so the step loop never blocks in ``emit``.  A
    consumer that stops draining is cut with EOVERCROWDED at the next
    step boundary; a raising ``emit`` retires just that request with
    EINTERNAL.  ``on_done(err)`` fires exactly once per request, after
    its buffered tokens.
  * retire: a request that finished cleanly offers its materialised
    pages to the radix tree, so the next prompt sharing the prefix hits.
  * speculative mode (``draft_runner=``, a proposer from
    ``serving/speculative.py`` or a model runner): each iteration
    PROPOSES draft branches per slot, leases their pages (branch 0
    appended in-sequence by ``store.speculate``, side branches on
    ``store.fork``s), VERIFIES every row of every slot in ONE
    ``runner.verify`` call of fixed shape ``[num_slots, draft_len + 1]``
    under an ancestry mask, and COMMITS the longest greedy-matching
    chain per slot: its K/V rows land in one ``write_kv_batch``, the
    rejected tail rolls back, and the accepted tokens plus the target's
    bonus token stream out.  The streams equal the plain step's.  A
    request may opt out (``submit(..., speculative=False)``); when no
    slot has a proposal the iteration is a plain step.
  * supervision (``on_crash=`` / ``set_crash_handler``, driven by
    ``serving/supervisor.py``): a step or verify that raises under a
    crash handler stops the loop with every slot INTACT -- requests
    unfinished, KV leases held -- and tells the handler; ``takeover()``
    then hands the slots and waiters to the supervisor.  The loop
    publishes a heartbeat every iteration, so a watchdog can tell a busy
    loop from a wedged or dead one.  After each step the loop commits
    only slots it still owns, under a commit lock that ``takeover()``
    takes too, so a stolen slot never receives another token from the
    old loop.  ``degraded_clamp`` (the overload ladder's) caps new
    submissions' ``max_new_tokens``.  Fault sites: ``serving.step``,
    ``serving.spec_verify``, ``serving.heartbeat`` (``fault.py``).
  * the native hot path (``native_path``, flag
    ``native_hot_path_enabled``, on by default): each request's emit
    buffer is a native ``TokenRing``; a step's tokens, for every slot,
    go out in ONE ``brpc_tokring_push_many`` inside the commit lock,
    and each emitter drains a batch per wakeup; page tables are filled
    by one native call.  The flag is read per request and per step:
    off, the Python ``_EmitBuf`` and the numpy fill give the same
    streams, and rings already handed out keep draining natively.
  * telemetry: a ``decode`` span per slot and a ``prefill`` span per
    admission, under the request's trace (the RPC server's span, or the
    supervisor's attempt span), with the KV store's annotations; the
    TTFT, inter-token and per-stage latency recorders; per-stage host
    CPU (``butil/hostcpu.py``); the named locks ``engine.slots``,
    ``engine.commit`` and ``serving.emit_buf``; the engine's counters
    as ``serving_<name>_*`` bvars.

Not in this port yet (see ROADMAP.md): the legacy step-function adapter
(and with it the raw-block mode).
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import logging
import re
import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np

from .. import errors, fault, native_path, rpcz
from .._core import lib as _lib
from ..butil import hostcpu, stagetag
from ..butil.lockprof import InstrumentedLock
from ..bvar import (Adder, IntRecorder, LatencyRecorder, PassiveStatus,
                    exposed_variables, find_exposed)
from ..device import resolve_device
from ..ops.paged_attention import MAX_LOCAL_WIDTH
from .speculative import as_proposer

_req_ids = itertools.count(1)
_log = logging.getLogger(__name__)

# hard per-request ceiling: a buggy max_new_tokens must not pin a slot
MAX_NEW_TOKENS_CAP = 65536

# serving-wide draft acceptance: one scrapeable ratio
SPEC_PROPOSED = Adder("serving_spec_proposed_tokens")
SPEC_ACCEPTED = Adder("serving_spec_accepted_tokens")


def _spec_accept_rate() -> float:
    p = SPEC_PROPOSED.get_value()
    return round(SPEC_ACCEPTED.get_value() / p, 4) if p else 0.0


PassiveStatus(_spec_accept_rate).expose("serving_spec_accept_rate")


@functools.cache
def latency_recorders() -> dict:
    """The serving-wide latency recorders: TTFT (submit -> first token
    in the emit buffer), inter-token gap, and the stages (queue =
    submit -> slot install, prefill, decode = install -> retire).  Made
    at the first engine, not at import: a native recorder loads the
    core."""
    return {name: LatencyRecorder(f"serving_{name}_us")
            for name in ("ttft", "itl", "stage_queue", "stage_prefill",
                         "stage_decode")}


class _EmitBuf:
    """Bounded token buffer between the step loop and one request's
    emitter thread (the flag-off path).  ``push`` never blocks; the
    terminal marker is always accepted."""

    __slots__ = ("cap", "q", "cv", "terminal", "has_terminal")

    def __init__(self, cap: int):
        self.cap = cap
        self.q: deque = deque()
        # every request's buffer shares ONE ledger row
        self.cv = threading.Condition(InstrumentedLock("serving.emit_buf"))
        self.terminal = None
        self.has_terminal = False

    def push(self, tok: int) -> bool:
        with self.cv:
            if len(self.q) >= self.cap:
                return False
            self.q.append(tok)
            self.cv.notify()
            return True

    def push_terminal(self, err) -> None:
        with self.cv:
            if not self.has_terminal:
                self.has_terminal = True
                self.terminal = err
            self.cv.notify()

    def pop(self, timeout_s: float):
        """``("tok", t)``, ``("done", err)`` once drained, or None."""
        with self.cv:
            if not self.q and not self.has_terminal:
                self.cv.wait(timeout_s)
            if self.q:
                return ("tok", self.q.popleft())
            if self.has_terminal:
                return ("done", self.terminal)
            return None


class _NativeEmitBuf:
    """A native bounded emit ring with the _EmitBuf protocol plus a
    batch pop.  The step loop pushes every slot's tokens in ONE
    ``brpc_tokring_push_many`` (``push`` here is the single-token
    entry), the emitter drains many tokens per wakeup.  The semantics
    are _EmitBuf's: push never blocks, a full ring cuts the consumer,
    the terminal is always accepted and surfaces after every buffered
    token."""

    __slots__ = ("ring", "cap", "popbuf")

    def __init__(self, ring, cap: int):
        self.ring = ring
        self.cap = cap
        # the emitter thread's scratch (single consumer)
        self.popbuf = (ctypes.c_int32 * min(int(cap), 512))()

    @property
    def handle(self):
        return self.ring.handle

    def push(self, tok: int) -> bool:
        return self.ring.push(int(tok))

    def push_terminal(self, err) -> None:
        self.ring.push_terminal(err)

    def pop_batch(self, timeout_s: float):
        """(count, terminal_seen, err); the tokens land in ``popbuf``."""
        return self.ring.pop_many(self.popbuf, timeout_s)


def _make_emit_buf(cap: int):
    ring = native_path.token_ring(cap)
    if ring is not None:
        return _NativeEmitBuf(ring, cap)
    return _EmitBuf(cap)


class _Request:
    __slots__ = ("req_id", "prompt", "max_new_tokens", "emit", "on_done",
                 "buf", "t_submit", "trace", "speculative", "_done_fired",
                 "_mu")

    def __init__(self, prompt: Sequence[int], max_new_tokens: int,
                 emit: Callable[[int], None], on_done: Optional[Callable],
                 emit_buffer: int, trace_ctx: Optional[tuple] = None,
                 speculative: bool = True):
        self.req_id = next(_req_ids)
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.speculative = bool(speculative)
        self.emit = emit
        self.on_done = on_done
        self.buf = _make_emit_buf(emit_buffer)
        self.t_submit = time.monotonic()
        # (trace_id, parent_span_id, sampled): the submitting thread's
        # current span (the RPC server's) or the supervisor's attempt
        # span; the decode slot runs on the engine thread, where the
        # context variable does not follow
        self.trace = trace_ctx if trace_ctx is not None \
            else rpcz.current_trace_ctx()
        self._done_fired = False
        self._mu = InstrumentedLock("serving.request")

    @property
    def done_fired(self) -> bool:
        return self._done_fired

    def finish(self, err: Optional[errors.RpcError]) -> None:
        """Exactly-once terminal notification."""
        with self._mu:
            if self._done_fired:
                return
            self._done_fired = True
        if self.on_done is not None:
            try:
                self.on_done(err)
            except Exception:
                _log.exception("engine on_done callback raised")


class _Slot:
    __slots__ = ("req", "seq", "last_token", "position", "generated",
                 "span", "t_install", "t_first_tok", "last_tok_t", "itl_n",
                 "itl_sum_s", "itl_max_s", "steps_run", "spec_steps",
                 "spec_proposed", "spec_accepted")

    def __init__(self, req: _Request, seq, span=rpcz.NULL_SPAN):
        self.req = req
        self.seq = seq
        self.last_token = req.prompt[-1]
        self.position = len(req.prompt)
        self.generated = 0
        self.span = span              # the slot's decode span
        self.t_install = time.monotonic()
        self.t_first_tok = 0.0
        self.last_tok_t = 0.0
        self.itl_n = 0                # inter-token gaps recorded
        self.itl_sum_s = 0.0
        self.itl_max_s = 0.0
        self.steps_run = 0            # engine iterations ridden
        self.spec_steps = 0           # verify iterations ridden
        self.spec_proposed = 0        # draft tokens proposed
        self.spec_accepted = 0        # draft tokens accepted


class _SpecPlan:
    """One slot's draft lease for one verify iteration: the proposed
    branches, the forks holding the side branches' pages, and each
    branch's rows inside the slot's block of the verify batch."""

    __slots__ = ("slot", "base", "branches", "forks", "rows")

    def __init__(self, slot: _Slot):
        self.slot = slot
        self.base = slot.position     # len(seq.tokens) before the draft
        self.branches: list = []      # token chains, branch 0 in-seq
        self.forks: list = []         # a KVSeq per side branch
        self.rows: list = []          # per branch: its row indices


class DecodeEngine:
    """Continuous decode loop over a fixed slot pool (see the module
    docstring).  ``runner`` and ``store`` must live on ``device``
    (default ``cuda``)."""

    def __init__(self, *, runner, store, num_slots: int = 8,
                 max_pages_per_slot: int = 64,
                 prefill_buckets: Sequence[int] = (16, 64, 256, 1024, 4096),
                 eos_token: Optional[int] = None, emit_buffer: int = 256,
                 draft_runner=None, draft_len: int = 4,
                 on_crash: Optional[Callable] = None,
                 device=None, name: str = "engine"):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if emit_buffer < 1:
            raise ValueError("emit_buffer must be >= 1")
        self.device = resolve_device(device)
        if store is None or store.device != self.device:
            raise ValueError(f"the engine on {self.device} needs a KV store "
                             f"on the same device")
        if getattr(runner, "device", self.device) != self.device:
            raise ValueError(f"runner lives on {runner.device}, engine on "
                             f"{self.device}")
        if runner.kv_bytes_per_token <= 0 or not runner.wants_pages:
            raise ValueError("the runner must write packed K/V rows over "
                             "page tables (a vector-KV ModelRunner)")
        # speculative decoding: a draft proposer turns the step into
        # propose -> verify -> commit; without one the plain step runs
        self._draft = as_proposer(draft_runner)
        self.draft_len = int(draft_len)
        if self._draft is not None:
            if self.draft_len < 1:
                raise ValueError("draft_len must be >= 1")
            if self.draft_len + 1 > MAX_LOCAL_WIDTH:
                raise ValueError(
                    f"draft_len + 1 = {self.draft_len + 1} exceeds the "
                    f"paged-attention kernel's local block "
                    f"({MAX_LOCAL_WIDTH} rows)")
        self.runner = runner
        self.store = store
        runner.bind(store)
        self.num_slots = int(num_slots)
        self.max_pages_per_slot = int(max_pages_per_slot)
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        self.eos_token = eos_token
        self.emit_buffer = int(emit_buffer)
        self.name = name
        self._rec = latency_recorders()
        safe = re.sub(r"\W", "_", name)
        # the EXACT names exposed here, so close() hides only this
        # engine's (a prefix wildcard would strip a sibling's too)
        pre = set(exposed_variables(f"serving_{safe}*"))
        self.steps = Adder(f"serving_{safe}_steps")
        self.tokens_out = Adder(f"serving_{safe}_tokens")
        self.retired = Adder(f"serving_{safe}_retired")
        self.admit_errors = Adder(f"serving_{safe}_admit_errors")
        self.emit_cut = Adder(f"serving_{safe}_emit_cut")
        self.occupancy_rec = IntRecorder(f"serving_{safe}_occupancy")
        PassiveStatus(self.active_count).expose(
            f"serving_{safe}_active_slots")
        self._bvar_names = [n for n in exposed_variables(f"serving_{safe}*")
                            if n not in pre]
        self.step_seconds = 0.0
        self.verify_calls = 0
        self.verify_seconds = 0.0
        self.propose_seconds = 0.0
        self.spec_steps = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_tokens = 0
        # supervision: a crash handler is told (slots left intact)
        # instead of failing the requests; the heartbeat tells a busy
        # loop from a wedged or dead one; degraded_clamp caps NEW
        # submissions' budgets
        self._on_crash = on_crash
        self._crashed: Optional[BaseException] = None
        self._taken_over = False
        self.degraded_clamp: Optional[int] = None
        self._prefill_fn_cpu_s = 0.0   # runner CPU of the last prefill
        self._beat_steps = 0
        self._beat_t = time.monotonic()
        # the one native push per step: (ring, token) pairs for every
        # slot's run of this iteration (a verify's burst per slot),
        # owned by the engine thread
        pushcap = self.num_slots * \
            (self.draft_len + 1 if self._draft is not None else 1)
        self._push_handles = (ctypes.c_void_p * pushcap)()
        self._push_toks = (ctypes.c_int32 * pushcap)()
        self._push_ok = (ctypes.c_uint8 * pushcap)()
        # held by the loop while it commits a step's results to its
        # slots (and pushes their tokens), and by takeover(): a takeover
        # lands between commits, never inside one
        self._commit_mu = InstrumentedLock("engine.commit")
        self._cv = threading.Condition(InstrumentedLock("engine.slots"))
        self._slots: list[Optional[_Slot]] = [None] * self.num_slots
        self._waiters: deque[_Request] = deque()
        # claimed from _waiters but not installed yet (admission runs
        # outside the cv): join_idle() must not report idle meanwhile
        self._admitting = 0
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"serving-engine-{name}")
        self._thread.start()
        from . import _register_engine
        _register_engine(self)

    # ---- submission ----

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               emit: Callable[[int], None],
               on_done: Optional[Callable] = None, *,
               clamp: bool = True, trace_ctx: Optional[tuple] = None,
               speculative: bool = True) -> int:
        """Queue a request for the next step boundary with a free slot.
        Returns the request id; ``on_done(err)`` fires exactly once.
        ``clamp=False`` exempts it from ``degraded_clamp`` (a
        supervisor's re-admission keeps the budget it was admitted
        with).  ``trace_ctx=(trace_id, parent_span_id, sampled)``
        replaces the calling thread's trace (the supervisor passes its
        attempt span).  ``speculative=False`` keeps a speculative engine
        from proposing for this request (it rides the verify batch as a
        plain row)."""
        limit = MAX_NEW_TOKENS_CAP
        brownout = self.degraded_clamp
        if clamp and brownout is not None:
            limit = min(limit, int(brownout))
        req = _Request(prompt, min(int(max_new_tokens), limit),
                       emit, on_done, self.emit_buffer, trace_ctx=trace_ctx,
                       speculative=speculative)
        if req.max_new_tokens <= 0:
            req.finish(errors.RpcError(errors.EREQUEST,
                                       "max_new_tokens must be > 0"))
            return req.req_id
        if not req.prompt:
            req.finish(errors.RpcError(errors.EREQUEST,
                                       "empty prompt (paged KV mode)"))
            return req.req_id
        with self._cv:
            closed = not self._running
            if not closed:
                self._waiters.append(req)
                self._cv.notify()
        if closed:
            req.finish(errors.RpcError(errors.ELOGOFF, "engine closed"))
        return req.req_id

    def _claim_waiters_locked(self) -> list:
        free = sum(1 for s in self._slots if s is None)
        claimed = []
        while len(claimed) < free and self._waiters:
            claimed.append(self._waiters.popleft())
        self._admitting += len(claimed)
        return claimed

    def _admit(self, req: _Request):
        """Admit one claimed request into the store and a free slot.  A
        failed admission finishes THAT request with ELIMIT.  Returns
        ``(index, slot)`` or None."""
        # the slot's decode span: under the request's trace, it carries
        # TTFT, the inter-token summary and the KV annotations of the
        # whole residency (NULL_SPAN with rpcz off: writes absorb free)
        tid, psid, smp = req.trace
        span = rpcz.new_span("decode", "Serving", self.name,
                             trace_id=tid, parent_span_id=psid,
                             sampled=smp if tid else None)
        queue_us = int((time.monotonic() - req.t_submit) * 1e6)
        self._rec["stage_queue"].add(queue_us)
        try:
            # reject before admit allocates anything: a prompt that
            # cannot fit the page table would decode on a truncated one
            need = -(-len(req.prompt) // self.store.page_tokens)
            if need > self.max_pages_per_slot:
                raise MemoryError(f"prompt needs {need} pages "
                                  f"(> max_pages_per_slot="
                                  f"{self.max_pages_per_slot})")
            seq = self.store.admit(req.prompt, span=span)
        except Exception as e:
            self.admit_errors.add(1)
            if span is not rpcz.NULL_SPAN:
                span.error_code = errors.ELIMIT
                span.annotate(f"kv admit failed: {type(e).__name__}: {e}")
                rpcz.submit(span)
            req.finish(errors.RpcError(
                errors.ELIMIT, f"KV admit failed: {type(e).__name__}: {e}"))
            return None
        if span is not rpcz.NULL_SPAN:
            span.annotate(f"slot install: queue_us={queue_us} "
                          f"prompt={len(req.prompt)} "
                          f"budget={req.max_new_tokens}")
        slot = _Slot(req, seq, span)
        with self._cv:
            if self._running:
                for i in range(self.num_slots):
                    if self._slots[i] is None:
                        self._slots[i] = slot
                        return (i, slot)
        # closed while admitting: close() already drained the waiters.
        # Under a takeover the prompt's pages are worth caching: the
        # supervisor resubmits this prompt, and its admission then hits
        taken = self._taken_over
        self.store.retire(seq, cache=taken)
        if span is not rpcz.NULL_SPAN:
            span.error_code = errors.ELOGOFF
            span.annotate("engine closed mid-admit"
                          + (" (supervisor takeover)" if taken else ""))
            rpcz.submit(span)
        req.finish(errors.RpcError(
            errors.ELOGOFF,
            "engine restarting (supervisor takeover)" if taken
            else "engine closed"))
        return None

    # ---- emitter threads (one per admitted request) ----

    def _start_emitter(self, req: _Request) -> None:
        threading.Thread(target=self._emit_pump, args=(req,), daemon=True,
                         name=f"serving-emit-{req.req_id}").start()

    def _emit_pump(self, req: _Request) -> None:
        if isinstance(req.buf, _NativeEmitBuf):
            return self._emit_pump_native(req)
        while True:
            item = req.buf.pop(0.25)
            if item is None:
                if req.done_fired:
                    return
                continue
            # the pop's wait burns no thread time: from here on it is
            # the delivery's own host CPU
            t_cpu0 = time.thread_time()
            kind, val = item
            if kind == "done":
                hostcpu.add("emit_fanout",
                            (time.thread_time() - t_cpu0) * 1e6)
                req.finish(val)
                return
            try:
                req.emit(val)
            except Exception as e:
                self._cancel(req, errors.RpcError(
                    errors.EINTERNAL,
                    f"emit failed: {type(e).__name__}: {e}"))
                return
            finally:
                hostcpu.add("emit_fanout",
                            (time.thread_time() - t_cpu0) * 1e6)

    def _emit_pump_native(self, req: _Request) -> None:
        """The native ring's emitter: each wakeup drains a batch of
        tokens in one call that waits off the interpreter lock, then
        delivers them; every buffered token goes out before on_done
        fires, exactly once."""
        buf: _NativeEmitBuf = req.buf
        out = buf.popbuf
        while True:
            n, term, err = buf.pop_batch(0.25)
            if n == 0 and not term:
                if req.done_fired:
                    return
                continue
            t_cpu0 = time.thread_time()
            try:
                for k in range(n):
                    req.emit(int(out[k]))
            except Exception as e:
                hostcpu.add("emit_fanout",
                            (time.thread_time() - t_cpu0) * 1e6)
                self._cancel(req, errors.RpcError(
                    errors.EINTERNAL,
                    f"emit failed: {type(e).__name__}: {e}"))
                return
            hostcpu.add("emit_fanout", (time.thread_time() - t_cpu0) * 1e6)
            if term:
                req.finish(err)
                return

    def _cancel(self, req: _Request, err) -> None:
        """Retire `req`'s slot from an emitter thread (its consumer
        died); finish() is exactly-once, so racing the loop is benign."""
        released = None
        with self._cv:
            for i, s in enumerate(self._slots):
                if s is not None and s.req is req:
                    released = self._release_slot_locked(i, cache_ok=False)
                    break
        if released is not None:
            self._finalize_slot(released, err.code)
        req.finish(err)

    # ---- prefill ----

    def _prefill(self, i: int, slot: _Slot) -> None:
        """Prefill the prompt's uncached suffix, bucket-padded; the
        cached prefix is skipped entirely."""
        self._prefill_fn_cpu_s = 0.0
        suffix = slot.req.prompt[slot.seq.prefill_from:]
        if not suffix:
            return
        n = len(suffix)
        bucket = next((b for b in self.prefill_buckets if n <= b), n)
        padded = np.zeros((bucket,), np.int32)
        padded[:n] = suffix
        positions = slot.seq.prefill_from + np.arange(bucket, dtype=np.int32)
        # the prefill span: the cached/uncached split is what a prefix
        # hit bought
        pspan = rpcz.NULL_SPAN
        if slot.span is not rpcz.NULL_SPAN:
            pspan = rpcz.new_span("prefill", "Serving", self.name,
                                  trace_id=slot.span.trace_id,
                                  parent_span_id=slot.span.span_id,
                                  sampled=slot.span.sampled)
            pspan.annotate(f"prefill: cached={slot.seq.prefill_from} "
                           f"uncached={n} bucket={bucket}")
        t0 = time.monotonic()
        t_fn_cpu = time.thread_time()
        try:
            self.runner.prefill(padded, positions, self._table_row(slot.seq),
                                seq=slot.seq)
        except Exception as e:
            self._prefill_fn_cpu_s = time.thread_time() - t_fn_cpu
            _log.exception("prefill failed")
            if pspan is not rpcz.NULL_SPAN:
                pspan.error_code = errors.EINTERNAL
                pspan.annotate(f"prefill failed: {type(e).__name__}: {e}")
                rpcz.submit(pspan)
            self._retire(i, errors.RpcError(
                errors.EINTERNAL, f"prefill failed: {type(e).__name__}: {e}"))
            return
        self._prefill_fn_cpu_s = time.thread_time() - t_fn_cpu
        self._rec["stage_prefill"].add(int((time.monotonic() - t0) * 1e6))
        rpcz.submit(pspan)

    # ---- the step loop ----

    def _table_row(self, seq) -> np.ndarray:
        """`seq`'s page ids as one fixed-width table row, -1 padded."""
        row = np.full((self.max_pages_per_slot,), -1, np.int32)
        ids = seq.page_ids()[:self.max_pages_per_slot]
        row[:len(ids)] = ids
        return row

    def _gather_page_tables(self, active) -> np.ndarray:
        if native_path.enabled():
            # one native fill (the interpreter lock released); the row
            # arrays stay referenced until it returns
            table = np.empty((self.num_slots, self.max_pages_per_slot),
                             np.int32)
            rows = [np.asarray(s.seq.page_ids(), np.int32)
                    for _, s in active]
            native_path.page_table_fill(table, rows, [i for i, _ in active])
            return table
        table = np.full((self.num_slots, self.max_pages_per_slot), -1,
                        np.int32)
        for i, s in active:
            table[i] = self._table_row(s.seq)
        return table

    def _loop(self) -> None:
        while True:
            self._touch_beat()
            with self._cv:
                if not self._running:
                    return
                claimed = self._claim_waiters_locked()
            for req in claimed:
                # admission and prefill are prefill work, though the
                # engine thread's name says decode_step
                with stagetag.stage("prefill"):
                    t_cpu0 = time.thread_time()
                    installed = self._admit(req)
                    with self._cv:
                        self._admitting -= 1
                    if installed is None:
                        hostcpu.add("prefill",
                                    (time.thread_time() - t_cpu0) * 1e6)
                        continue
                    i, s = installed
                    self._prefill(i, s)
                    hostcpu.add("prefill",
                                (time.thread_time() - t_cpu0
                                 - self._prefill_fn_cpu_s) * 1e6)
                    hostcpu.add("model_compute",
                                self._prefill_fn_cpu_s * 1e6)
                self._start_emitter(req)
                self._touch_beat()      # a long prefill is progress
            # drop this thread's references to the admitted requests: an
            # idle loop must not keep a finished request's emit ring alive
            claimed = req = installed = s = None
            with self._cv:
                if not self._running:
                    return
                active = [(i, s) for i, s in enumerate(self._slots)
                          if s is not None]
                if not active:
                    if not self._waiters:
                        # bounded, so an idle loop keeps beating
                        self._cv.wait(0.25)
                    continue
            step = self._spec_step if self._draft is not None \
                else self._step
            if not step(active):
                return

    # ---- supervision ----

    def _touch_beat(self) -> None:
        """Publish step-loop progress for a watchdog.  The
        ``serving.heartbeat`` fault site SUPPRESSES the beat while the
        loop keeps running: a wedge, as the watchdog sees it."""
        if fault.ENABLED and fault.hit(
                fault.HEARTBEAT, name=self.name) is not None:
            return
        self._beat_steps += 1
        self._beat_t = time.monotonic()

    def heartbeat(self) -> tuple:
        """(progress counter, monotonic time of the last beat)."""
        return self._beat_steps, self._beat_t

    def has_work(self) -> bool:
        with self._cv:
            return (self._admitting > 0 or bool(self._waiters)
                    or any(s is not None for s in self._slots))

    def set_crash_handler(self, fn: Optional[Callable]) -> None:
        self._on_crash = fn

    @property
    def crashed(self) -> Optional[BaseException]:
        return self._crashed

    def _crash(self, exc: BaseException) -> None:
        """A supervised step failure: stop the loop with every slot
        intact and tell the crash handler (on this thread: it must only
        signal)."""
        with self._cv:
            self._crashed = exc
            self._running = False
            self._cv.notify_all()
        try:
            self._on_crash(self, exc)
        except Exception:
            _log.exception("engine crash handler raised")

    def _fail_active(self, active, err) -> None:
        """Unsupervised step failure: retire every active request with a
        definite error, so a broken step never wedges its callers."""
        for i, _ in active:
            self._retire(i, err)

    def _step(self, active) -> bool:
        """One decode iteration across every active slot.  Returns False
        when the loop must stop (a supervised crash)."""
        t_cpu0 = time.thread_time()
        tok = np.zeros((self.num_slots,), np.int32)
        pos = np.zeros((self.num_slots,), np.int32)
        for i, s in active:
            tok[i] = s.last_token
            pos[i] = s.position
        pages = self._gather_page_tables(active)
        t0 = time.perf_counter()
        t_fn_cpu = time.thread_time()
        try:
            if fault.ENABLED and fault.hit(
                    fault.STEP, name=self.name) is not None:
                raise RuntimeError("injected decode step crash")
            out, kv_rows = self.runner.step(tok, pos, pages)
        except Exception as e:
            if self._on_crash is not None:
                # an ENGINE failure, not the requests': the slots stay
                # for the supervisor's takeover
                self._crash(e)
                return False
            _log.exception("decode step failed")
            self._fail_active(active, errors.RpcError(
                errors.EINTERNAL,
                f"decode step failed: {type(e).__name__}: {e}"))
            return True
        # runner.step returns host tokens, so the device work is done
        self.step_seconds += time.perf_counter() - t0
        fn_cpu_s = time.thread_time() - t_fn_cpu
        self.steps.add(1)
        self.occupancy_rec.add(len(active))
        with self._commit_mu:
            self._commit_step(active, out, kv_rows)
        # this iteration's bookkeeping, the runner call apart
        hostcpu.add("decode_step",
                    (time.thread_time() - t_cpu0 - fn_cpu_s) * 1e6)
        hostcpu.add("model_compute", fn_cpu_s * 1e6)
        return True

    def _commit_step(self, active, out, kv_rows) -> None:
        """Write the step's K/V rows and emit its tokens, for the slots
        this loop still owns (an emitter may have cancelled one, a
        takeover stolen all)."""
        t_tok = time.monotonic()
        items = [(i, s) for i, s in active if self._slots[i] is s]
        fails = self.store.write_kv_batch(
            [(s.seq, s.position - 1, kv_rows[i:i + 1]) for i, s in items])
        bad = set()
        for wi, e in fails:
            i, _ = items[wi]
            bad.add(i)
            self._retire(i, errors.RpcError(
                errors.EINTERNAL, f"KV write failed: {type(e).__name__}: "
                                  f"{e}"))
        deliver = []
        for i, s in active:
            if i in bad or self._slots[i] is not s:
                continue      # an emitter cancelled it mid-step
            nxt = int(out[i])
            s.last_token = nxt
            s.position += 1
            s.generated += 1
            s.steps_run += 1
            self.tokens_out.add(1)
            hostcpu.tokens_total.add(1)
            self._record_arrival(s, t_tok)
            if not self._extend(i, s, nxt):
                continue
            if self._page_overflow(i, s):
                continue
            deliver.append((i, s, (nxt,)))
        self._emit_runs(deliver)

    def _extend(self, i: int, s: _Slot, tok: int) -> bool:
        """Append `tok` to slot i's sequence; on failure retire the slot
        (ELIMIT when the pool is out of pages) and return False."""
        try:
            self.store.extend(s.seq, tok)
            return True
        except MemoryError as e:
            err = errors.RpcError(errors.ELIMIT,
                                  f"KV page alloc failed: {e}")
        except Exception as e:
            err = errors.RpcError(
                errors.EINTERNAL,
                f"KV extend failed: {type(e).__name__}: {e}")
        self._retire(i, err)
        return False

    def _page_overflow(self, i: int, s: _Slot) -> bool:
        """Retire slot i with ELIMIT when its sequence outgrew the fixed
        page table."""
        if len(s.seq.pages) <= self.max_pages_per_slot:
            return False
        self._retire(i, errors.RpcError(
            errors.ELIMIT,
            f"page table overflow (> {self.max_pages_per_slot} pages)"))
        return True

    def _record_arrival(self, s: _Slot, t_tok: float) -> None:
        """TTFT at a slot's first tokens, one inter-token gap after
        (one per verify burst: a burst's tokens arrive together)."""
        if s.last_tok_t:
            gap = t_tok - s.last_tok_t
            self._rec["itl"].add(int(gap * 1e6))
            s.itl_n += 1
            s.itl_sum_s += gap
            s.itl_max_s = max(s.itl_max_s, gap)
        else:
            s.t_first_tok = t_tok
            ttft_us = int((t_tok - s.req.t_submit) * 1e6)
            self._rec["ttft"].add(ttft_us)
            if s.span is not rpcz.NULL_SPAN:
                s.span.annotate(f"first token: ttft_us={ttft_us}")
        s.last_tok_t = t_tok

    def _emit_runs(self, deliver: list) -> None:
        """Stream each ``(i, slot, tokens)`` of this iteration, then
        retire the slots that are done.  A consumer that stopped
        draining is cut here, without the step loop ever blocking in a
        write."""
        for (i, s, toks), ok in zip(deliver, self._push_token_runs(deliver)):
            if not ok:
                self.emit_cut.add(1)
                if s.span is not rpcz.NULL_SPAN:
                    s.span.annotate(
                        f"emit-buffer stall: {self.emit_buffer} buffered "
                        f"tokens undrained, consumer cut")
                self._retire(i, errors.RpcError(
                    errors.EOVERCROWDED,
                    "slow stream consumer: emit buffer overflow"))
            elif s.generated >= s.req.max_new_tokens or \
                    (self.eos_token is not None
                     and toks[-1] == self.eos_token):
                self._retire(i, None)

    def _push_token_runs(self, deliver: list) -> list:
        """THE emit fan-out: every native ring's run rides ONE
        ``brpc_tokring_push_many`` (the interpreter lock released) as
        consecutive (ring, token) pairs, which the rings keep in call
        order; a Python _EmitBuf pushes token by token.  An entry reads
        False when any of its tokens did not land: its consumer is cut,
        so a partial burst only ever precedes an error terminal.  The
        slots in ``deliver`` hold their requests, and so the rings,
        alive across the native call."""
        ok = [True] * len(deliver)
        native = []               # (entry index, token)
        for k, (_, s, toks) in enumerate(deliver):
            buf = s.req.buf
            if isinstance(buf, _NativeEmitBuf):
                native.extend((k, t) for t in toks)
            else:
                for t in toks:
                    if not buf.push(t):
                        ok[k] = False
                        break
        if native:
            h, t = self._push_handles, self._push_toks
            for j, (k, tk) in enumerate(native):
                h[j] = deliver[k][1].req.buf.handle
                t[j] = tk
            _lib.core.brpc_tokring_push_many(h, t, len(native),
                                             self._push_ok)
            for j, (k, _) in enumerate(native):
                if not self._push_ok[j]:
                    ok[k] = False
        return ok

    # ---- speculative decoding ----

    def _spec_release(self, plan: _SpecPlan) -> None:
        """Return one slot's draft lease: roll the sequence back to its
        length before the draft (unless its slot was released meanwhile)
        and retire every fork.  Runs on every exit that does not commit,
        so no path leaks a draft page."""
        seq = plan.slot.seq
        if seq is not None and not seq.retired \
                and len(seq.tokens) > plan.base:
            try:
                self.store.rollback(seq, plan.base)
            except Exception:
                _log.exception("draft rollback failed")
        for f in plan.forks:
            if f is not None:
                self.store.retire(f, cache=False)
        plan.forks = []

    def _spec_propose(self, s: _Slot) -> list:
        """Draft branches for one slot, clamped to the verify rows, the
        token budget (one token is the bonus) and the fixed page table.
        Empty when the request opted out, has no headroom, or the
        proposer has nothing: the slot then rides the verify batch as a
        plain row."""
        rem = s.req.max_new_tokens - s.generated
        if not s.req.speculative or rem <= 1:
            return []
        avail = self.max_pages_per_slot * self.store.page_tokens \
            - s.position - 1
        cap = min(self.draft_len, rem - 1, avail)
        if cap < 1:
            return []
        try:
            branches = self._draft.propose(s.seq.tokens, cap)
        except Exception:
            _log.exception("draft proposer failed")
            return []        # a broken proposer costs speed, never output
        kept, total = [], 0
        for b in branches:
            b = [int(t) for t in b][:cap - total]
            if not b:
                break
            kept.append(b)
            total += len(b)
        return kept

    def _spec_step(self, active) -> bool:
        """One speculative iteration (see the module docstring).  Slots
        at different accept depths, and slots with no draft, share the
        one fixed-shape verify batch.  Returns False when the loop must
        stop (a supervised crash)."""
        t_cpu0 = time.thread_time()
        k1 = self.draft_len + 1
        # ---- propose + lease ----
        t0 = time.perf_counter()
        plans: dict[int, _SpecPlan] = {}
        for i, s in active:
            plan = plans[i] = _SpecPlan(s)
            branches = self._spec_propose(s)
            if not branches:
                continue
            try:
                # forks first, so they share only the pre-draft pages; the
                # in-sequence draft then copies the shared tail page
                for b in branches[1:]:
                    f = self.store.fork(s.seq)
                    plan.forks.append(f)
                    self.store.speculate(f, b)
                self.store.speculate(s.seq, branches[0])
                plan.branches = branches
            except Exception:
                # lease pressure: this slot degrades to a plain row
                self._spec_release(plan)
        self.propose_seconds += time.perf_counter() - t0
        if not any(p.branches for p in plans.values()):
            # no draft anywhere: a (draft_len+1)-wide verify would pay
            # ~k1x the work for one token per slot
            return self._step(active)
        # ---- the fixed-shape verify batch ----
        n = self.num_slots
        tok = np.zeros((n, k1), np.int32)
        pos = np.zeros((n, k1), np.int32)
        tables = np.full((n * k1, self.max_pages_per_slot), -1, np.int32)
        base_len = np.zeros((n * k1,), np.int32)
        mask = np.zeros((n, k1, k1), bool)
        for i, s in active:
            plan = plans[i]
            main = self._table_row(s.seq)
            # row 0: the plain step's query (the last token), over the
            # materialised keys 0..position-2
            tok[i, 0] = s.last_token
            pos[i, 0] = s.position
            tables[i * k1] = main
            base_len[i * k1] = s.position - 1
            mask[i, 0, 0] = True
            r = 1
            for bi, b in enumerate(plan.branches):
                ids = main if bi == 0 else self._table_row(plan.forks[bi - 1])
                rows: list = []
                for c, t in enumerate(b):
                    tok[i, r] = t
                    pos[i, r] = s.position + c + 1
                    tables[i * k1 + r] = ids
                    base_len[i * k1 + r] = s.position - 1
                    # the root, the branch's ancestors, itself
                    mask[i, r, [0, *rows, r]] = True
                    rows.append(r)
                    r += 1
                plan.rows.append(rows)
        # ---- verify: every row of every slot, one call ----
        t0 = time.perf_counter()
        t_fn_cpu = time.thread_time()
        try:
            if fault.ENABLED and fault.hit(
                    fault.SPEC_VERIFY, name=self.name) is not None:
                raise RuntimeError("injected speculative verify crash")
            out, kv_rows = self.runner.verify(tok, pos, tables, base_len,
                                              mask)
        except Exception as e:
            # the draft leases FIRST: a failed verify leaves no draft page
            # behind, whether the supervisor takes over or not
            for plan in plans.values():
                self._spec_release(plan)
            if self._on_crash is not None:
                self._crash(e)
                return False
            _log.exception("speculative verify failed")
            self._fail_active(active, errors.RpcError(
                errors.EINTERNAL,
                f"speculative verify failed: {type(e).__name__}: {e}"))
            return True
        # runner.verify returns host tokens, so the device work is done
        dt = time.perf_counter() - t0
        fn_cpu_s = time.thread_time() - t_fn_cpu
        self.step_seconds += dt
        self.verify_seconds += dt
        self.steps.add(1)
        self.occupancy_rec.add(len(active))
        self.verify_calls += 1
        with self._commit_mu:
            self._commit_verify(active, plans, tok, out, kv_rows)
        hostcpu.add("decode_step",
                    (time.thread_time() - t_cpu0 - fn_cpu_s) * 1e6)
        hostcpu.add("model_compute", fn_cpu_s * 1e6)
        return True

    def _commit_verify(self, active, plans, tok, out, kv_rows) -> None:
        """Accept, commit and emit one verify's results for the slots
        this loop still owns; a slot released meanwhile gets its draft
        lease back."""
        t_tok = time.monotonic()
        # ---- accept + commit ----
        writes, owners = [], []
        staged: dict[int, tuple] = {}
        for i, s in active:
            plan = plans[i]
            if self._slots[i] is not s:
                # an emitter cancelled it mid-verify; its release retired
                # the sequence, the forks are still ours
                self._spec_release(plan)
                continue
            # greedy tree walk: the true token after each row is the
            # target's argmax there; the winner is the longest branch
            # that matches it step by step
            t_star = int(out[i, 0])
            path, winner = [], -1
            for bi, rows in enumerate(plan.rows):
                if int(tok[i, rows[0]]) != t_star:
                    continue
                sel = [rows[0]]
                for r in rows[1:]:
                    if int(tok[i, r]) != int(out[i, sel[-1]]):
                        break
                    sel.append(r)
                if len(sel) > len(path):
                    path, winner = sel, bi
            bonus = int(out[i, path[-1]]) if path else t_star
            toks = [int(tok[i, r]) for r in path] + [bonus]
            if self.eos_token is not None and self.eos_token in toks:
                toks = toks[:toks.index(self.eos_token) + 1]
            toks = toks[:s.req.max_new_tokens - s.generated]
            kept = min(len(toks), len(path))
            try:
                if winner > 0:
                    # a side branch won: the slot adopts its fork; the
                    # original, with branch 0's draft, retires uncached
                    f = plan.forks[winner - 1]
                    plan.forks[winner - 1] = None
                    f.prefill_from = s.seq.prefill_from
                    f.span = s.seq.span
                    self.store.retire(s.seq, cache=False)
                    s.seq = f
                self.store.rollback(s.seq, plan.base + kept)
                for f in plan.forks:
                    if f is not None:
                        self.store.retire(f, cache=False)
                plan.forks = []
            except Exception as e:
                self._spec_release(plan)
                self._retire(i, errors.RpcError(
                    errors.EINTERNAL,
                    f"draft commit failed: {type(e).__name__}: {e}"))
                continue
            # row 0 (the query position, as the plain step writes it),
            # then the accepted drafts: one run of rows for branch 0
            idx = [0] + path[:kept]
            rows = kv_rows[i, :kept + 1] if idx[-1] == kept \
                else kv_rows[i, idx]
            writes.append((s.seq, plan.base - 1, rows))
            owners.append(i)
            staged[i] = (toks, kept, sum(map(len, plan.branches)))
        fails = self.store.write_kv_batch(writes) if writes else []
        for wi, e in fails:
            i = owners[wi]
            staged.pop(i, None)
            self._retire(i, errors.RpcError(
                errors.EINTERNAL,
                f"KV write failed: {type(e).__name__}: {e}"))
        # ---- bookkeeping + emission ----
        deliver = []
        for i, s in active:
            st = staged.get(i)
            if st is None:
                continue
            if self._slots[i] is not s:
                # cancelled mid-commit: the release retired the sequence
                # the slot held then; an adopted fork is still ours (a
                # takeover keeps the sequence for detach instead)
                if not self._taken_over and not s.seq.retired:
                    self.store.retire(s.seq, cache=False)
                continue
            toks, kept, proposed = st
            if len(toks) > kept and not self._extend(i, s, toks[-1]):
                continue             # the bonus token: the next query
            if self._page_overflow(i, s):
                continue
            s.last_token = toks[-1]
            s.position = len(s.seq.tokens)
            s.generated += len(toks)
            s.steps_run += 1
            s.spec_steps += 1
            s.spec_proposed += proposed
            s.spec_accepted += kept
            self.tokens_out.add(len(toks))
            hostcpu.tokens_total.add(len(toks))
            self.spec_steps += 1
            self.spec_proposed += proposed
            self.spec_accepted += kept
            self.spec_tokens += len(toks)
            SPEC_PROPOSED.add(proposed)
            SPEC_ACCEPTED.add(kept)
            self._record_arrival(s, t_tok)
            deliver.append((i, s, toks))
        self._emit_runs(deliver)

    def _release_slot_locked(self, i: int, cache_ok: bool = True):
        """Free slot i under the cv, retiring its sequence exactly once
        (cached into the radix tree only on clean completion)."""
        s = self._slots[i]
        if s is None:
            return None
        self._slots[i] = None
        self.retired.add(1)
        self.store.retire(s.seq, cache=cache_ok)
        return s

    def _finalize_slot(self, s: _Slot, err_code: int) -> None:
        """Close a retiring slot's telemetry: the decode span (the
        inter-token summary, the error code) and one record in the
        serving registry's recent-generation ring."""
        dur_us = int((time.monotonic() - s.t_install) * 1e6)
        self._rec["stage_decode"].add(dur_us)
        ttft_us = int((s.t_first_tok - s.req.t_submit) * 1e6) \
            if s.t_first_tok else 0
        itl_avg_us = int(s.itl_sum_s / s.itl_n * 1e6) if s.itl_n else 0
        itl_max_us = int(s.itl_max_s * 1e6)
        spec = None
        if self._draft is not None and s.spec_steps:
            spec = {
                "spec_proposed": s.spec_proposed,
                "spec_accepted": s.spec_accepted,
                "accept_rate": round(s.spec_accepted / s.spec_proposed, 4)
                if s.spec_proposed else 0.0,
                "draft_depth": round(s.spec_proposed / s.spec_steps, 2),
                # over every iteration, the plain-step ones too
                "tokens_per_step": round(s.generated / max(1, s.steps_run),
                                         2),
            }
        span = s.span
        if span is not rpcz.NULL_SPAN:
            span.error_code = span.error_code or err_code
            span.annotate(
                f"retired: generated={s.generated} ttft_us={ttft_us} "
                f"itl_avg_us={itl_avg_us} itl_max_us={itl_max_us}")
            if spec is not None:
                span.annotate(
                    f"speculative: accept_rate={spec['accept_rate']} "
                    f"draft_depth={spec['draft_depth']} "
                    f"tokens_per_step={spec['tokens_per_step']} "
                    f"({spec['spec_accepted']}/{spec['spec_proposed']} "
                    f"drafts accepted over {s.spec_steps} verifies)")
            rpcz.submit(span)
        from . import record_generation
        record_generation({
            "engine": self.name,
            "req_id": s.req.req_id,
            "trace_id": span.trace_id,
            "prompt_len": len(s.req.prompt),
            "prefix_hit": s.seq.prefix_hit_tokens,
            "generated": s.generated,
            "ttft_us": ttft_us,
            "itl_avg_us": itl_avg_us,
            "itl_max_us": itl_max_us,
            "duration_us": dur_us,
            "error_code": err_code,
            **(spec or {}),
        })

    def _retire(self, i: int, err) -> None:
        with self._cv:
            s = self._release_slot_locked(i, cache_ok=err is None)
        if s is not None:
            self._finalize_slot(s, err.code if err is not None else 0)
            s.req.buf.push_terminal(err)

    # ---- lifecycle / introspection ----

    def takeover(self) -> tuple:
        """Stop a crashed or wedged engine WITHOUT finishing its
        requests: detach every in-flight slot and queued waiter.  Returns
        ``(slots, waiters)``; the caller now owns each slot's sequence
        and each request's terminal.  Waits out a commit in progress (a
        bounded section), never a step: a loop still inside
        ``runner.step`` finds its slots gone when it returns."""
        with self._commit_mu:
            with self._cv:
                self._running = False
                self._taken_over = True
                self._cv.notify_all()
                stolen = [s for s in self._slots if s is not None]
                self._slots = [None] * self.num_slots
                waiters, self._waiters = list(self._waiters), deque()
        return stolen, waiters

    def active_count(self) -> int:
        with self._cv:
            return sum(1 for s in self._slots if s is not None)

    def queue_depth(self) -> float:
        """Admission backlog per slot (queued and mid-admission waiters
        over ``num_slots``): the ladder's queue-depth pressure."""
        with self._cv:
            queued = len(self._waiters) + self._admitting
        return queued / max(1, self.num_slots)

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop the loop; in-flight and queued requests finish with
        ELOGOFF and every sequence retires.  The store is the caller's
        and stays up."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
        self._thread.join(timeout_s)
        err = errors.RpcError(errors.ELOGOFF, "engine closed")
        with self._cv:
            released = [self._release_slot_locked(i, cache_ok=False)
                        for i in range(self.num_slots)]
            waiters, self._waiters = list(self._waiters), deque()
        for s in filter(None, released):
            self._finalize_slot(s, errors.ELOGOFF)
            s.req.buf.push_terminal(err)
        for req in waiters:
            req.finish(err)
        # unpin the exposed variables: their bound methods would keep a
        # closed engine alive in the registry
        for n in self._bvar_names:
            v = find_exposed(n)
            if v is not None:
                v.hide()

    def join_idle(self, timeout_s: float = 30.0) -> bool:
        """Block until no request is active or queued."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._cv:
                if not self._waiters and not self._admitting and all(
                        s is None for s in self._slots):
                    return True
            time.sleep(0.005)
        return False

    def stats(self) -> dict:
        with self._cv:
            slot_map = [
                None if s is None else {
                    "req_id": s.req.req_id,
                    "generated": s.generated,
                    "max_new_tokens": s.req.max_new_tokens,
                    "position": s.position,
                    "pages": len(s.seq.pages),
                    "prefix_hit": s.seq.prefix_hit_tokens,
                    "speculative": s.req.speculative,
                    "spec_steps": s.spec_steps,
                    "spec_proposed": s.spec_proposed,
                    "spec_accepted": s.spec_accepted,
                } for s in self._slots]
            queued = len(self._waiters) + self._admitting
        out = {
            "num_slots": self.num_slots,
            "slots": slot_map,
            "queued": queued,
            "steps": self.steps.get_value(),
            "step_seconds": self.step_seconds,
            "tokens": self.tokens_out.get_value(),
            "retired": self.retired.get_value(),
            "admit_errors": self.admit_errors.get_value(),
            "emit_buffer": self.emit_buffer,
            "emit_cut": self.emit_cut.get_value(),
            "avg_step_occupancy": round(self.occupancy_rec.get_value(), 2),
            "heartbeat_steps": self._beat_steps,
            "heartbeat_age_s": round(time.monotonic() - self._beat_t, 3),
            "crashed": self._crashed is not None,
            "degraded_clamp": self.degraded_clamp,
            "speculative": None if self._draft is None else {
                "proposer": getattr(self._draft, "name", "draft"),
                "draft_len": self.draft_len,
                "verify_calls": self.verify_calls,
                "verify_seconds": self.verify_seconds,
                "propose_seconds": self.propose_seconds,
                "spec_steps": self.spec_steps,
                "spec_proposed": self.spec_proposed,
                "spec_accepted": self.spec_accepted,
                "spec_tokens": self.spec_tokens,
                "accept_rate": (self.spec_accepted / self.spec_proposed
                                if self.spec_proposed else 0.0),
                "tokens_per_verify": (self.spec_tokens / self.spec_steps
                                      if self.spec_steps else 0.0),
            },
            "runner": self.runner.name,
            "kvcache": self.store.name,
            "device": str(self.device),
        }
        if self._draft is not None:
            out["draft"] = getattr(self._draft, "name", "draft")
            out["draft_len"] = self.draft_len
        return out
