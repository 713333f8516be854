"""Deadline-aware dynamic batcher: coalesces concurrent unary RPCs into
batched tensor calls.

A copy of ``brpc_tpu/serving/batcher.py``.  The batcher gathers
concurrent requests under a ``max_batch_size`` / ``max_delay_us``
policy, pads them to a SMALL FIXED SET of bucket shapes, runs the batch
through one batch function and scatters the rows back to each caller.
A :class:`~brpc_tpu_torch.models.runner.ModelRunner` drops in as the
batch function: its ``score`` (or, with a prefix cache,
``score_with_offsets``) runs the dense forward -- the flash-attention
kernel on a card -- on whatever device the runner lives on.

  * admission is deadline-aware: a request whose deadline would expire
    before the predicted batch completion (window wait + EMA batch time x
    batches ahead) is shed at once with ELIMIT; an optional concurrency
    limiter (``create_limiter`` specs: int, "auto", "timeout[:ms]")
    gates the queue depth the same way;
  * BROWNOUT (``brownout``, set by an EngineSupervisor's ladder): at
    level >= 1 deadline-less requests, the lowest lane, are shed at
    admission with ELIMIT;
  * PRIORITY LANES: formation is earliest-deadline-first, the FIFO head
    always keeping one seat (no starvation); a request selected over an
    earlier one counts as a lane promotion;
  * EAGER mode: an arrival finding the batcher idle runs inline on the
    submitting thread, and the drainer forms whatever queued while the
    last batch ran, with no window wait;
  * PREFIX-AWARE PREFILL (``prefix_cache=``, a KVCacheStore): token
    prompts are trimmed to their uncached suffix at formation, the
    matched pages pinned for the batch's lifetime; a two-argument batch
    function receives each row's start offset.

Formation zero-fills the bucket and copies every row in one native call
(``native_path.batch_pad``, the port's ``_fastrpc`` over its buffers,
releasing the interpreter lock); with ``native_hot_path_enabled`` off,
the reference's numpy pad loop.  Instrumented through ``bvar``: batch
size, queue delay (native latency recorder), pad waste, sheds, lane
promotions, prefix-skip ratio; each request has an rpcz ``batch`` span
under the submitting thread's trace (queue delay, promotion, prefix
trim, shed); formation's host CPU goes to ``hostcpu``'s
``batch_formation`` (the batch function's to ``model_compute``); the
queue lock is the named ``batcher.queue``.
"""
from __future__ import annotations

import logging
import re
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .. import errors, fault, native_path, rpcz
from ..butil import hostcpu
from ..butil.lockprof import InstrumentedLock
from ..bvar import Adder, IntRecorder, LatencyRecorder, PassiveStatus
from ..bvar.variable import exposed_variables, find_exposed
from ..models.runner import ModelRunner
from ..policy.concurrency_limiter import create_limiter

_log = logging.getLogger(__name__)

# default sequence-length buckets: a small fixed ladder, so any raw
# length maps to one of a handful of shapes
DEFAULT_LENGTH_BUCKETS = (16, 64, 256, 1024, 4096)


def required_positional_args(fn) -> int:
    """How many REQUIRED positional parameters `fn` takes (-1 when its
    signature is unreadable).  A parameter with a default is not
    counted -- passing the offsets into e.g. ``temperature=1.0`` would
    silently corrupt compute -- and ``*args`` counts for nothing (pass
    ``pass_offsets`` for those)."""
    import inspect
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return -1
    return sum(1 for p in params
               if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
               and p.default is p.empty)


def _bucket_up(n: int, buckets: Sequence[int]) -> Optional[int]:
    for b in buckets:
        if n <= b:
            return b
    return None


def _default_batch_buckets(max_batch_size: int) -> tuple:
    out = []
    b = 1
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(max_batch_size)
    return tuple(out)


class _Pending:
    """One queued request: the row it will occupy plus an exactly-once
    completion (error or result, never neither, never both)."""

    __slots__ = ("item", "length", "skip", "enqueue_t", "deadline_s",
                 "span", "_fire", "_fired", "_mu")

    def __init__(self, item: np.ndarray, length: int,
                 deadline_s: Optional[float],
                 fire: Callable[[int, str, object], None]):
        self.item = item
        self.length = length
        self.skip = 0              # prefix tokens served from the KV cache
        self.enqueue_t = time.monotonic()
        self.deadline_s = deadline_s
        # the request's batch span, opened at enqueue under the caller's
        # trace: queue delay heads it, shed/promotion/trim annotate it
        self.span = rpcz.NULL_SPAN
        self._fire = fire
        self._fired = False
        self._mu = InstrumentedLock("batcher.pending")

    def complete(self, code: int, text: str, result) -> None:
        with self._mu:
            if self._fired:
                return
            self._fired = True
        span = self.span
        if span is not rpcz.NULL_SPAN:
            # the exactly-once completion submits the span exactly once
            if code:
                span.error_code = code
                span.annotate(f"completed with error {code}: {text}")
            rpcz.submit(span)
        try:
            self._fire(code, text, result)
        except Exception:
            # a raising completion callback must never kill the drainer
            _log.exception("batcher completion callback raised")


class _Future:
    """Local (non-RPC) completion for submit_wait()."""

    def __init__(self):
        self._ev = threading.Event()
        self.code = 0
        self.text = ""
        self.result = None

    def fire(self, code: int, text: str, result) -> None:
        self.code, self.text, self.result = code, text, result
        self._ev.set()

    def wait(self, timeout_s: float):
        if not self._ev.wait(timeout_s):
            raise errors.RpcError(errors.ERPCTIMEDOUT,
                                  "batcher result not ready")
        if self.code:
            raise errors.RpcError(self.code, self.text)
        return self.result


class DynamicBatcher:
    """Per-method dynamic batcher.

    ``batch_fn(padded)`` receives a ``[batch_bucket, length_bucket]``
    numpy array (row i = request i's item, zero-padded) and returns
    either a per-row vector (``[batch]``) or a padded matrix (``[batch,
    length_bucket]``, trimmed back to each request's raw length on
    scatter); numpy arrays and torch tensors (on any device) are both
    taken.  A ModelRunner drops in as ``batch_fn``.
    """

    def __init__(self, batch_fn: Callable, *,
                 max_batch_size: int = 16,
                 max_delay_us: int = 2000,
                 batch_buckets: Optional[Sequence[int]] = None,
                 length_buckets: Sequence[int] = DEFAULT_LENGTH_BUCKETS,
                 limiter=None,
                 prefix_cache=None,
                 pass_offsets: Optional[bool] = None,
                 name: str = "default",
                 dtype=np.float32,
                 padded_output: Optional[bool] = None,
                 eager: bool = False):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if isinstance(batch_fn, ModelRunner):
            # Serving.Score over a real model: per-position next-token
            # ids from the dense forward, trimmed per row by the scatter;
            # with a prefix cache the offsets variant rides the trim
            batch_fn = (batch_fn.score_with_offsets
                        if prefix_cache is not None else batch_fn.score)
        self.batch_fn = batch_fn
        self.max_batch_size = int(max_batch_size)
        self.max_delay_us = int(max_delay_us)
        self.batch_buckets = tuple(sorted(
            batch_buckets or _default_batch_buckets(max_batch_size)))
        if self.batch_buckets[-1] < self.max_batch_size:
            raise ValueError("largest batch bucket must cover "
                             "max_batch_size")
        self.length_buckets = tuple(sorted(length_buckets))
        self.name = name
        self.dtype = np.dtype(dtype)
        # how to scatter batch_fn's output back to callers:
        #   True  -- output is [batch, length_bucket]: trim row i to the
        #            request's raw length;
        #   False -- rows are per-request values of fixed width (or
        #            scalars): hand row i back whole;
        #   None  -- infer per batch (trim iff the trailing dim equals the
        #            length bucket); pass it explicitly when a fixed
        #            width could coincide with a length bucket
        self.padded_output = padded_output
        self.limiter = create_limiter(limiter) if limiter is not None \
            else None
        # a KVCacheStore (or anything with probe/acquire_prefix/release)
        self.prefix_cache = prefix_cache
        # a batch_fn with TWO required positionals receives the rows'
        # start offsets; pass_offsets overrides the detection
        if pass_offsets is not None:
            self._fn_wants_offsets = bool(pass_offsets)
        else:
            self._fn_wants_offsets = (
                prefix_cache is not None
                and required_positional_args(batch_fn) >= 2)

        safe = re.sub(r"\W", "_", name)
        # the EXACT names exposed here, so close() hides only this
        # batcher's (a prefix wildcard would strip a sibling's too)
        pre = set(exposed_variables(f"serving_{safe}*"))
        self.batch_size_rec = IntRecorder(f"serving_{safe}_batch_size")
        # the native recorder loads (and on first use builds) the core,
        # whose brpc_batch_pad formation calls
        self.queue_delay_rec = LatencyRecorder(f"serving_{safe}_queue_delay")
        self.shed = Adder(f"serving_{safe}_shed")
        self.brownout_shed = Adder(f"serving_{safe}_brownout_shed")
        self.n_batches = Adder(f"serving_{safe}_batches")
        self.n_completed = Adder(f"serving_{safe}_completed")
        self.n_bypassed = Adder(f"serving_{safe}_bypassed")
        self.n_errors = Adder(f"serving_{safe}_errors")
        self.lane_promotions = Adder(f"serving_{safe}_lane_promotions")
        self._pad_elems = Adder()    # padded-but-unused elements
        self._real_elems = Adder()   # useful elements
        self._skip_elems = Adder()   # prefix elements served from cache
        self._seen_elems = Adder()   # total elements offered
        PassiveStatus(self._pad_waste).expose(
            f"serving_{safe}_pad_waste_ratio")
        PassiveStatus(self._prefix_skip_ratio).expose(
            f"serving_{safe}_prefix_skip_ratio")
        self._bvar_names = [n for n in exposed_variables(f"serving_{safe}*")
                            if n not in pre]

        # EAGER mode: an idle arrival runs inline (a batch of one, no
        # cross-thread hop); the drainer forms whatever is queued with no
        # window wait.  One batch in flight at a time (inline or
        # drainer), guarded by self._cv's lock.
        self.eager = bool(eager)
        self._executing = False

        # overload-ladder level (0 = healthy), written by a supervisor
        self.brownout = 0

        self._cv = threading.Condition(InstrumentedLock("batcher.queue"))
        self._q: list[_Pending] = []
        self._exec_ema_s = 0.0
        self._fn_cpu_s = 0.0     # batch_fn CPU of the batch in flight
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"serving-batcher-{safe}")
        self._thread.start()
        from . import _register_batcher
        _register_batcher(self)

    # ---- the idle cut-through claim (eager mode) ----

    def try_claim_idle(self) -> bool:
        """Claim the execution slot for ONE request a caller serves
        outside the batcher: only in eager mode, with no queue, no batch
        in flight, no brownout and the batcher running.  Pair with
        :meth:`release_idle`."""
        if not self.eager or self.brownout >= 1:
            return False
        with self._cv:
            if not self._running or self._q or self._executing:
                return False
            self._executing = True
        self.n_bypassed.add(1)
        return True

    def release_idle(self) -> None:
        with self._cv:
            self._executing = False
            self._cv.notify_all()

    # ---- admission ----

    def submit(self, cntl, item, transform: Optional[Callable] = None,
               ) -> None:
        """Server-handler entry: defers the RPC, enqueues the item, and
        completes the call from the batch drainer.  The deadline is the
        request meta's ``timeout_ms``; ``transform(row)`` maps the
        scattered row to the response object."""
        done = cntl.defer()

        def fire(code: int, text: str, result) -> None:
            if code:
                cntl.set_failed(code, text)
                done(None)
                return
            if transform is not None:
                # a raising transform still completes the RPC, with a
                # definite EINTERNAL instead of a timeout
                try:
                    result = transform(result)
                except Exception as e:
                    cntl.set_failed(errors.EINTERNAL,
                                    f"response transform failed: "
                                    f"{type(e).__name__}: {e}")
                    done(None)
                    return
            done(result)

        meta = cntl.request_meta
        tmo_ms = meta.timeout_ms if meta is not None else 0
        deadline_s = (time.monotonic() + tmo_ms / 1e3) if tmo_ms > 0 \
            else None
        self.enqueue(item, fire, deadline_s=deadline_s)

    def submit_wait(self, item, timeout_s: float = 30.0,
                    deadline_s: Optional[float] = None):
        """Local blocking submission: returns the scattered row or raises
        RpcError."""
        fut = _Future()
        self.enqueue(item, fut.fire, deadline_s=deadline_s)
        return fut.wait(timeout_s)

    def enqueue(self, item, fire: Callable[[int, str, object], None],
                deadline_s: Optional[float] = None) -> None:
        """Core admission: validates the item, predicts completion, and
        either queues or sheds.  ``fire(code, text, result)`` runs
        exactly once."""
        arr = np.asarray(item, dtype=self.dtype)
        if arr.ndim == 0:
            arr = arr.reshape(1)
        p = _Pending(arr, 0, deadline_s, fire)
        # under the enqueuing thread's trace (the RPC server's span);
        # set before any complete() path, so every outcome submits it
        p.span = rpcz.child_span("batch", "Serving", self.name)
        if arr.ndim != 1:
            p.complete(errors.EREQUEST,
                       f"batcher items must be 1-D, got shape {arr.shape}",
                       None)
            self.n_errors.add(1)
            return
        p.length = arr.shape[0]
        if _bucket_up(p.length, self.length_buckets) is None:
            # an over-length item is still admissible when the prefix
            # cache holds enough of it that the SUFFIX fits a bucket
            # (advisory probe; the binding trim happens at formation)
            fits = False
            if self.prefix_cache is not None and p.length > 1:
                try:
                    hit = int(self.prefix_cache.probe(arr))
                except Exception:
                    hit = 0
                hit = max(0, min(hit, p.length - 1))
                fits = _bucket_up(p.length - hit,
                                  self.length_buckets) is not None
            if not fits:
                p.complete(errors.EREQUEST,
                           f"item length {p.length} exceeds largest "
                           f"bucket {self.length_buckets[-1]}", None)
                self.n_errors.add(1)
                return
        shed_code = 0
        shed_text = ""
        brownout = 0
        inline = False
        with self._cv:
            if not self._running:
                shed_code, shed_text = errors.ELOGOFF, "batcher closed"
            elif self.brownout >= 1 and p.deadline_s is None:
                # ladder level >= 1: the lowest lane (deadline-less, which
                # EDF ranks last) is refused at the door
                shed_code = errors.ELIMIT
                shed_text = (f"brownout level {self.brownout}: "
                             f"lowest-priority lane shed")
                brownout = 1
            elif self.limiter is not None and not self.limiter.on_requested(
                    len(self._q) + 1):
                shed_code = errors.ELIMIT
                shed_text = "batcher queue limiter rejected the request"
            elif p.deadline_s is not None:
                # predicted completion: the batching window (none in
                # eager mode) plus one EMA execution per batch ahead,
                # plus our own
                batches_ahead = len(self._q) // self.max_batch_size
                window_s = 0.0 if self.eager else self.max_delay_us / 1e6
                predicted_s = (window_s +
                               (batches_ahead + 1) *
                               max(self._exec_ema_s, 0.0))
                if p.deadline_s < p.enqueue_t + predicted_s:
                    shed_code = errors.ELIMIT
                    shed_text = (
                        f"deadline-aware shed: deadline in "
                        f"{(p.deadline_s - p.enqueue_t) * 1e3:.1f}ms but "
                        f"predicted batch completion in "
                        f"{predicted_s * 1e3:.1f}ms")
            if shed_code == 0:
                if self.eager and not self._q and not self._executing:
                    # cut-through: the idle batcher runs this request as
                    # the batch on the submitting thread
                    self._executing = True
                    inline = True
                else:
                    self._q.append(p)
                    self._cv.notify()
        if shed_code != 0:
            if shed_code == errors.ELIMIT:
                self.shed.add(1)
                if brownout:
                    self.brownout_shed.add(1)
                if self.limiter is not None and not brownout:
                    # a brownout shed never consumed a limiter slot
                    self.limiter.on_responded(errors.ELIMIT, 0)
            self.n_errors.add(1)
            p.complete(shed_code, shed_text, None)
            return
        if inline:
            try:
                self._run_batch([p])
            except Exception:
                _log.exception("inline batch execution failed")
                p.complete(errors.EINTERNAL, "batch drainer error", None)
            finally:
                with self._cv:
                    self._executing = False
                    self._cv.notify_all()

    # ---- the batch loop ----

    def _loop(self) -> None:
        while True:
            with self._cv:
                while True:
                    if self.eager and self._executing:
                        # one batch in flight: park while an inline batch
                        # runs, during shutdown too (close()'s flush must
                        # not run concurrently with it)
                        self._cv.wait()
                        continue
                    if self._running and not self._q:
                        self._cv.wait()
                        continue
                    break
                if not self._q:
                    if not self._running:
                        return
                    continue
                if not self.eager:
                    # the batch window, anchored at the first request
                    deadline_t = self._q[0].enqueue_t \
                        + self.max_delay_us / 1e6
                    while self._running and \
                            len(self._q) < self.max_batch_size:
                        rem = deadline_t - time.monotonic()
                        if rem <= 0:
                            break
                        self._cv.wait(rem)
                batch = self._form_batch_locked()
                if batch and self.eager:
                    self._executing = True
            if not batch:
                continue
            try:
                self._run_batch(batch)
            except Exception:
                # the drainer must survive any failure or the batcher
                # wedges
                _log.exception("batch drainer iteration failed")
                for p in batch:
                    p.complete(errors.EINTERNAL, "batch drainer error",
                               None)
            finally:
                if self.eager:
                    with self._cv:
                        self._executing = False
                        self._cv.notify_all()

    def _form_batch_locked(self) -> list[_Pending]:
        """This batch's members: the FIFO head, then earliest deadlines
        first (deadline-less last, FIFO among equals).  A member selected
        over an earlier-enqueued request that stays queued counts as one
        lane promotion."""
        if len(self._q) <= self.max_batch_size:
            batch, self._q = self._q, []
            return batch
        order = sorted(
            range(1, len(self._q)),
            key=lambda i: (self._q[i].deadline_s
                           if self._q[i].deadline_s is not None
                           else float("inf"), i))
        taken = {0} | set(order[: self.max_batch_size - 1])
        take = sorted(taken)
        first_left = min(i for i in range(len(self._q)) if i not in taken)
        promoted = sum(1 for i in take if i > first_left)
        if promoted:
            self.lane_promotions.add(promoted)
            for i in take:
                if i > first_left and \
                        self._q[i].span is not rpcz.NULL_SPAN:
                    self._q[i].span.annotate(
                        "lane promotion: EDF selected this request "
                        "ahead of an earlier-enqueued one")
        batch = [self._q[i] for i in take]
        for i in reversed(take):
            del self._q[i]
        return batch

    def _run_batch(self, batch: list[_Pending]) -> None:
        # host CPU of formation: everything here but the batch
        # function, which _execute times into _fn_cpu_s
        t_cpu0 = time.thread_time()
        self._fn_cpu_s = 0.0
        try:
            self._run_batch_inner(batch)
        finally:
            hostcpu.add("batch_formation",
                        (time.thread_time() - t_cpu0 - self._fn_cpu_s)
                        * 1e6)
            hostcpu.add("model_compute", self._fn_cpu_s * 1e6)

    def _run_batch_inner(self, batch: list[_Pending]) -> None:
        now = time.monotonic()
        live: list[_Pending] = []
        for p in batch:
            if p.deadline_s is not None and p.deadline_s < now:
                # expired while queued: shed rather than compute a row
                # nobody waits for
                self.shed.add(1)
                self.n_errors.add(1)
                if self.limiter is not None:
                    self.limiter.on_responded(errors.ELIMIT, 0)
                p.complete(errors.ELIMIT,
                           "deadline expired before batch formation", None)
            else:
                qd_us = int((now - p.enqueue_t) * 1e6)
                self.queue_delay_rec.add(qd_us)
                if p.span is not rpcz.NULL_SPAN:
                    p.span.annotate(f"batch formed: queue_delay_us={qd_us}"
                                    f" members={len(batch)}")
                live.append(p)
        if not live:
            return
        pinned: list = []
        try:
            live = self._trim_prefixes(live, pinned)
            if live:
                self._execute(live)
        finally:
            # the pinned prefix pages outlive the compute
            if pinned and self.prefix_cache is not None:
                try:
                    self.prefix_cache.release(pinned)
                except Exception:
                    _log.exception("prefix page release failed")

    def _trim_prefixes(self, live: list[_Pending], pinned: list) -> list:
        """Formation-time prefix trim: pin each item's cached prefix
        pages and keep only its uncached suffix.  A row whose suffix no
        longer fits a bucket (its pages were evicted since admission)
        completes with a definite error."""
        if self.prefix_cache is None:
            return live
        kept = []
        for p in live:
            hit, pages = 0, []
            if p.length > 1:
                try:
                    hit, pages = self.prefix_cache.acquire_prefix(p.item)
                except Exception:
                    hit, pages = 0, []
            pinned.extend(pages)
            hit = max(0, min(hit, p.length - 1))
            if hit:
                if p.span is not rpcz.NULL_SPAN:
                    p.span.annotate(
                        f"kv prefix trim: {hit}/{p.length} tokens served "
                        f"from {len(pages)} pinned cached pages")
                p.skip = hit
                p.item = p.item[hit:]
                p.length -= hit
            if _bucket_up(p.length, self.length_buckets) is None:
                self.n_errors.add(1)
                if self.limiter is not None:
                    self.limiter.on_responded(errors.EREQUEST, 0)
                p.complete(errors.EREQUEST,
                           f"suffix length {p.length} exceeds largest "
                           f"bucket (cached prefix evicted since "
                           f"admission)", None)
            else:
                kept.append(p)
        return kept

    def _form_batch(self, live: list[_Pending], bshape: int,
                    lbucket: int) -> np.ndarray:
        """The (bshape, lbucket) padded batch with live[i] in row i: the
        zero-fill and every row's copy in ONE native call, which
        releases the interpreter lock; the numpy loop with the native
        hot path off."""
        if native_path.enabled():
            padded = np.empty((bshape, lbucket), dtype=self.dtype)
            # enqueue() made every item a 1-D array of self.dtype; a
            # suffix trim keeps it contiguous, ascontiguousarray guards
            # the native copy
            native_path.batch_pad(
                padded, [np.ascontiguousarray(p.item) for p in live])
            return padded
        padded = np.zeros((bshape, lbucket), dtype=self.dtype)
        for i, p in enumerate(live):
            padded[i, : p.length] = p.item
        return padded

    def _execute(self, live: list[_Pending]) -> None:
        n = len(live)
        bshape = _bucket_up(n, self.batch_buckets)
        lbucket = _bucket_up(max(p.length for p in live),
                             self.length_buckets)
        padded = self._form_batch(live, bshape, lbucket)
        real = 0
        skipped = 0
        for p in live:
            real += p.length
            skipped += p.skip
        self._real_elems.add(real)
        self._pad_elems.add(bshape * lbucket - real)
        # skip metrics count EXECUTED rows only, like pad waste
        self._skip_elems.add(skipped)
        self._seen_elems.add(real + skipped)
        self.batch_size_rec.add(n)
        self.n_batches.add(1)
        t0 = time.monotonic()
        t_fn_cpu = time.thread_time()
        try:
            if fault.ENABLED and fault.hit(
                    fault.BATCH, name=self.name, batch=n) is not None:
                raise RuntimeError("injected mid-batch failure")
            if self._fn_wants_offsets:
                offsets = np.zeros((bshape,), np.int32)
                for i, p in enumerate(live):
                    offsets[i] = p.skip
                out = self.batch_fn(padded, offsets)
            else:
                out = self.batch_fn(padded)
            if isinstance(out, torch.Tensor):
                out = out.detach().cpu().numpy()
            out = np.asarray(out)
        except Exception as e:
            self._fn_cpu_s = time.thread_time() - t_fn_cpu
            # a failed batch completes EVERY member exactly once with a
            # definite error: never a hang, never a partial scatter
            self.n_errors.add(n)
            for p in live:
                if self.limiter is not None:
                    self.limiter.on_responded(errors.EINTERNAL, 0)
                p.complete(errors.EINTERNAL,
                           f"batch execution failed: "
                           f"{type(e).__name__}: {e}", None)
            return
        self._fn_cpu_s = time.thread_time() - t_fn_cpu
        dt = time.monotonic() - t0
        self._exec_ema_s = dt if self._exec_ema_s == 0.0 \
            else 0.7 * self._exec_ema_s + 0.3 * dt
        trim = self.padded_output if self.padded_output is not None \
            else (out.ndim >= 2 and out.shape[-1] == lbucket)
        for i, p in enumerate(live):
            row = out[i, : p.length] if trim else out[i]
            lat_us = int((time.monotonic() - p.enqueue_t) * 1e6)
            if self.limiter is not None:
                self.limiter.on_responded(0, lat_us)
            self.n_completed.add(1)
            p.complete(0, "", row)

    # ---- lifecycle / introspection ----

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop accepting; the drainer flushes queued batches (no window
        wait) and exits.  The exposed variables are hidden: their bound
        methods would otherwise keep a closed batcher alive."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
        self._thread.join(timeout_s)
        # anything still queued (drainer died / timeout): definite error
        with self._cv:
            leftovers, self._q = self._q, []
        for p in leftovers:
            p.complete(errors.ELOGOFF, "batcher closed", None)
        for n in self._bvar_names:
            v = find_exposed(n)
            if v is not None:
                v.hide()

    def _pad_waste(self) -> float:
        real = self._real_elems.get_value()
        pad = self._pad_elems.get_value()
        total = real + pad
        return round(pad / total, 4) if total else 0.0

    def _prefix_skip_ratio(self) -> float:
        seen = self._seen_elems.get_value()
        return round(self._skip_elems.get_value() / seen, 4) if seen \
            else 0.0

    def stats(self) -> dict:
        with self._cv:
            queued = len(self._q)
        return {
            "max_batch_size": self.max_batch_size,
            "max_delay_us": self.max_delay_us,
            "eager": self.eager,
            "batch_buckets": list(self.batch_buckets),
            "length_buckets": list(self.length_buckets),
            "queued": queued,
            "batches": self.n_batches.get_value(),
            "completed": self.n_completed.get_value(),
            "bypassed": self.n_bypassed.get_value(),
            "errors": self.n_errors.get_value(),
            "shed": self.shed.get_value(),
            "brownout": self.brownout,
            "brownout_shed": self.brownout_shed.get_value(),
            "lane_promotions": self.lane_promotions.get_value(),
            "avg_batch_size": round(self.batch_size_rec.get_value(), 2),
            "pad_waste_ratio": self._pad_waste(),
            "prefix_skip_ratio": self._prefix_skip_ratio(),
            "queue_delay_avg_us": round(self.queue_delay_rec.latency(), 1),
            "queue_delay_p99_us": round(
                self.queue_delay_rec.latency_percentile(0.99), 1),
            "exec_ema_ms": round(self._exec_ema_s * 1e3, 3),
        }
