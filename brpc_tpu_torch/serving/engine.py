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

Not in this port yet (see ROADMAP.md): the native token ring, rpcz
spans and host-CPU accounting, the bvar counters and the legacy
step-function adapter.
"""
from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np

from .. import errors, fault
from ..device import resolve_device
from ..ops.paged_attention import MAX_LOCAL_WIDTH
from .speculative import as_proposer

_req_ids = itertools.count(1)
_log = logging.getLogger(__name__)

# hard per-request ceiling: a buggy max_new_tokens must not pin a slot
MAX_NEW_TOKENS_CAP = 65536


class _EmitBuf:
    """Bounded token buffer between the step loop and one request's
    emitter thread.  ``push`` never blocks; the terminal marker is
    always accepted."""

    __slots__ = ("cap", "q", "cv", "terminal", "has_terminal")

    def __init__(self, cap: int):
        self.cap = cap
        self.q: deque = deque()
        self.cv = threading.Condition(threading.Lock())
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


class _Request:
    __slots__ = ("req_id", "prompt", "max_new_tokens", "emit", "on_done",
                 "buf", "speculative", "_done_fired", "_mu")

    def __init__(self, prompt: Sequence[int], max_new_tokens: int,
                 emit: Callable[[int], None], on_done: Optional[Callable],
                 emit_buffer: int, speculative: bool = True):
        self.req_id = next(_req_ids)
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.speculative = bool(speculative)
        self.emit = emit
        self.on_done = on_done
        self.buf = _EmitBuf(emit_buffer)
        self._done_fired = False
        self._mu = threading.Lock()

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
                 "spec_steps", "spec_proposed", "spec_accepted")

    def __init__(self, req: _Request, seq):
        self.req = req
        self.seq = seq
        self.last_token = req.prompt[-1]
        self.position = len(req.prompt)
        self.generated = 0
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
        self.steps = 0
        self.step_seconds = 0.0
        self.tokens_out = 0
        self.retired = 0
        self.admit_errors = 0
        self.emit_cut = 0
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
        self._beat_steps = 0
        self._beat_t = time.monotonic()
        # held by the loop while it commits a step's results to its
        # slots, and by takeover(): a takeover lands between commits,
        # never inside one
        self._commit_mu = threading.Lock()
        self._cv = threading.Condition(threading.Lock())
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
               clamp: bool = True, speculative: bool = True) -> int:
        """Queue a request for the next step boundary with a free slot.
        Returns the request id; ``on_done(err)`` fires exactly once.
        ``clamp=False`` exempts it from ``degraded_clamp`` (a
        supervisor's re-admission keeps the budget it was admitted
        with).  ``speculative=False`` keeps a speculative engine from
        proposing for this request (it rides the verify batch as a plain
        row)."""
        limit = MAX_NEW_TOKENS_CAP
        brownout = self.degraded_clamp
        if clamp and brownout is not None:
            limit = min(limit, int(brownout))
        req = _Request(prompt, min(int(max_new_tokens), limit),
                       emit, on_done, self.emit_buffer, speculative)
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
        seq = None
        try:
            # reject before admit allocates anything: a prompt that
            # cannot fit the page table would decode on a truncated one
            need = -(-len(req.prompt) // self.store.page_tokens)
            if need > self.max_pages_per_slot:
                raise MemoryError(f"prompt needs {need} pages "
                                  f"(> max_pages_per_slot="
                                  f"{self.max_pages_per_slot})")
            seq = self.store.admit(req.prompt)
        except Exception as e:
            self.admit_errors += 1
            req.finish(errors.RpcError(
                errors.ELIMIT, f"KV admit failed: {type(e).__name__}: {e}"))
            return None
        slot = _Slot(req, seq)
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
        while True:
            item = req.buf.pop(0.25)
            if item is None:
                if req.done_fired:
                    return
                continue
            kind, val = item
            if kind == "done":
                req.finish(val)
                return
            try:
                req.emit(val)
            except Exception as e:
                self._cancel(req, errors.RpcError(
                    errors.EINTERNAL,
                    f"emit failed: {type(e).__name__}: {e}"))
                return

    def _cancel(self, req: _Request, err) -> None:
        """Retire `req`'s slot from an emitter thread (its consumer
        died); finish() is exactly-once, so racing the loop is benign."""
        with self._cv:
            for i, s in enumerate(self._slots):
                if s is not None and s.req is req:
                    self._release_slot_locked(i, cache_ok=False)
                    break
        req.finish(err)

    # ---- prefill ----

    def _prefill(self, i: int, slot: _Slot) -> None:
        """Prefill the prompt's uncached suffix, bucket-padded; the
        cached prefix is skipped entirely."""
        suffix = slot.req.prompt[slot.seq.prefill_from:]
        if not suffix:
            return
        n = len(suffix)
        bucket = next((b for b in self.prefill_buckets if n <= b), n)
        padded = np.zeros((bucket,), np.int32)
        padded[:n] = suffix
        positions = slot.seq.prefill_from + np.arange(bucket, dtype=np.int32)
        try:
            self.runner.prefill(padded, positions, self._table_row(slot.seq),
                                seq=slot.seq)
        except Exception as e:
            _log.exception("prefill failed")
            self._retire(i, errors.RpcError(
                errors.EINTERNAL, f"prefill failed: {type(e).__name__}: {e}"))

    # ---- the step loop ----

    def _table_row(self, seq) -> np.ndarray:
        """`seq`'s page ids as one fixed-width table row, -1 padded."""
        row = np.full((self.max_pages_per_slot,), -1, np.int32)
        ids = seq.page_ids()[:self.max_pages_per_slot]
        row[:len(ids)] = ids
        return row

    def _gather_page_tables(self, active) -> np.ndarray:
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
                installed = self._admit(req)
                with self._cv:
                    self._admitting -= 1
                if installed is None:
                    continue
                i, s = installed
                self._prefill(i, s)
                self._start_emitter(req)
                self._touch_beat()      # a long prefill is progress
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
        tok = np.zeros((self.num_slots,), np.int32)
        pos = np.zeros((self.num_slots,), np.int32)
        for i, s in active:
            tok[i] = s.last_token
            pos[i] = s.position
        pages = self._gather_page_tables(active)
        t0 = time.perf_counter()
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
        self.steps += 1
        with self._commit_mu:
            self._commit_step(active, out, kv_rows)
        return True

    def _commit_step(self, active, out, kv_rows) -> None:
        """Write the step's K/V rows and emit its tokens, for the slots
        this loop still owns (an emitter may have cancelled one, a
        takeover stolen all)."""
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
        for i, s in active:
            if i in bad or self._slots[i] is not s:
                continue      # an emitter cancelled it mid-step
            nxt = int(out[i])
            s.last_token = nxt
            s.position += 1
            s.generated += 1
            self.tokens_out += 1
            if not self._extend(i, s, nxt):
                continue
            if self._page_overflow(i, s):
                continue
            self._emit_run(i, s, [nxt])

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

    def _emit_run(self, i: int, s: _Slot, toks: list) -> None:
        """Stream slot i's tokens of this iteration, then retire it if it
        is done.  A consumer that stopped draining is cut here, without
        the step loop ever blocking in a write."""
        if not all(s.req.buf.push(t) for t in toks):
            self.emit_cut += 1
            self._retire(i, errors.RpcError(
                errors.EOVERCROWDED,
                "slow stream consumer: emit buffer overflow"))
        elif s.generated >= s.req.max_new_tokens or \
                (self.eos_token is not None and toks[-1] == self.eos_token):
            self._retire(i, None)

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
        self.step_seconds += dt
        self.verify_seconds += dt
        self.steps += 1
        self.verify_calls += 1
        with self._commit_mu:
            self._commit_verify(active, plans, tok, out, kv_rows)
        return True

    def _commit_verify(self, active, plans, tok, out, kv_rows) -> None:
        """Accept, commit and emit one verify's results for the slots
        this loop still owns; a slot released meanwhile gets its draft
        lease back."""
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
            s.spec_steps += 1
            s.spec_proposed += proposed
            s.spec_accepted += kept
            self.tokens_out += len(toks)
            self.spec_steps += 1
            self.spec_proposed += proposed
            self.spec_accepted += kept
            self.spec_tokens += len(toks)
            self._emit_run(i, s, toks)

    def _release_slot_locked(self, i: int, cache_ok: bool = True):
        """Free slot i under the cv, retiring its sequence exactly once
        (cached into the radix tree only on clean completion)."""
        s = self._slots[i]
        if s is None:
            return None
        self._slots[i] = None
        self.retired += 1
        self.store.retire(s.seq, cache=cache_ok)
        return s

    def _retire(self, i: int, err) -> None:
        with self._cv:
            s = self._release_slot_locked(i, cache_ok=err is None)
        if s is not None:
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
            s.req.buf.push_terminal(err)
        for req in waiters:
            req.finish(err)

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
        return {
            "num_slots": self.num_slots,
            "slots": slot_map,
            "queued": queued,
            "steps": self.steps,
            "step_seconds": self.step_seconds,
            "tokens": self.tokens_out,
            "retired": self.retired,
            "admit_errors": self.admit_errors,
            "emit_buffer": self.emit_buffer,
            "emit_cut": self.emit_cut,
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
