"""rpcz -- per-RPC and per-stage trace spans and their on-disk database
(a copy of ``brpc_tpu/rpcz.py``).

A span records one timeline entry: kind (server, client, batch,
prefill, decode, generation), service and method, start and end, error
code, annotations.  The port's server installs its span as the CURRENT
span (a context variable) around the handler, so spans made inside it
-- the batcher's per-request span, the engine's decode span, the
supervisor's generation span -- join its trace; a client call made
inside a handler stamps the current trace onto the outgoing meta.
Sampling is decided once per trace, at its root, and inherited.

Submission: with the native hot path on (``native_path``), ``submit``
is one lock-free push onto the port's native span queue
(``_fastrpc.spanq_push``) and a drainer thread moves spans into the
bounded recent-span store; with it off, spans ride the shared
``bvar.collector.Collector``.  Either way ``flush``/``recent_spans``
observe the caller's own prior submissions.

Tracing is off by default (the ``rpcz_enabled`` flag): span objects
are only built when it is on, and the hot path otherwise touches one
shared null span.

The span database (``set_database_dir``, the ``rpcz_database_dir``
flag): every span that lands in the recent-span store is also appended,
on the collector or drainer thread, to recordio segments of JSON
records (``span_to_dict``'s keys) under that directory; a segment
rotates at 16 MiB and the newest 4 are kept.  ``load_disk_spans`` reads
them back, so ``/rpcz?trace_id=`` finds a trace the bounded in-memory
store has lost.  Segments are the JAX package's format, in both
directions.
"""
from __future__ import annotations

import atexit
import contextvars
import itertools
import json
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from . import flags
from ._core import lib as _lib
from .butil.lockprof import InstrumentedLock
from .butil.recordio import RecordReader, RecordWriter

# the CURRENT span is a context variable: it follows a context copied
# into another thread or task, and nothing else
_current_span: contextvars.ContextVar = contextvars.ContextVar(
    "rpcz_span", default=None)
# pid-salted span ids: spans collected in several processes merge into
# one tree without id collisions; the low 16 pid bits in bits 40..55
# keep the id inside the wire's uint64 with 2^40 spans per process
_span_counter = itertools.count(((os.getpid() & 0xFFFF) << 40) | 1)

_COLLECT_MAX = 2048
_collected: deque = deque(maxlen=_COLLECT_MAX)
# monotone collection cursor: each span landing in _collected gets the
# next seq, so a reader can pull "spans since my last pull"
_collect_seq = 0
_collect_lock = InstrumentedLock("rpcz.collect")

_ENABLED = flags.define_flag("rpcz_enabled", False)
_SAMPLE_RATE = flags.define_flag("rpcz_sample_rate", 1.0)


def set_enabled(on: bool, sample_rate: float = 1.0) -> None:
    """Turn tracing on or off (the ``rpcz_enabled`` and
    ``rpcz_sample_rate`` flags)."""
    flags.set_flag("rpcz_enabled", bool(on), force=True)
    flags.set_flag("rpcz_sample_rate", float(sample_rate), force=True)


def enabled() -> bool:
    return _ENABLED.value


def sample_rate() -> float:
    return _SAMPLE_RATE.value


@dataclass
class Span:
    trace_id: int = 0
    span_id: int = 0
    parent_span_id: int = 0
    service: str = ""
    method: str = ""
    remote_side: str = ""
    start_us: int = 0
    end_us: int = 0
    request_size: int = 0
    response_size: int = 0
    error_code: int = 0
    kind: str = "server"   # server | client | batch | prefill | decode |
    #                        generation
    annotations: list = field(default_factory=list)
    # the head-sampling decision, made ONCE at the trace root and
    # inherited by every span of the trace (a kept trace has no holes)
    sampled: bool = True
    # crash-recovery link: the span_id of the pre-crash attempt this
    # span resumes (supervisor re-admission); 0 when not a resumption
    recovered_from: int = 0
    # migration link: the span_id of the source's migrate span whose
    # pages this splice installed (0 when not a migration splice)
    migrated_from: int = 0
    # position in this process's recent-span store, set on landing
    seq: int = 0

    @property
    def latency_us(self) -> int:
        return max(0, self.end_us - self.start_us)

    def annotate(self, msg: str) -> None:
        self.annotations.append((int(time.time() * 1e6), msg))


class _NullSpan:
    """The stand-in while tracing is off: absorbs attribute writes,
    reads as zeros and empties.  One shared instance, never
    collected."""
    __slots__ = ()
    trace_id = 0
    span_id = 0
    parent_span_id = 0
    start_us = 0
    end_us = 0
    request_size = 0
    response_size = 0
    error_code = 0
    latency_us = 0
    service = ""
    method = ""
    remote_side = ""
    kind = ""
    annotations = ()
    sampled = True
    recovered_from = 0
    migrated_from = 0
    seq = 0

    def __setattr__(self, k, v):
        pass

    def annotate(self, msg):
        pass


NULL_SPAN = _NullSpan()


def now_us() -> int:
    return int(time.time() * 1e6)


def new_span(kind: str, service: str = "", method: str = "",
             trace_id: int = 0, parent_span_id: int = 0,
             sampled: bool | None = None) -> Span:
    """Create a span.  Head sampling is PER TRACE: a fresh root (no
    trace_id) rolls the sample-rate die once; a span joining a trace
    inherits the root's decision, from ``sampled`` (the wire's
    ``FLAG_TRACE_SAMPLED`` bit) or from the current span of the same
    trace.  A kept trace arrives whole; a dropped one leaves nothing."""
    if not _ENABLED.value:
        return NULL_SPAN
    if sampled is None:
        if trace_id:
            cur = _current_span.get()
            sampled = cur.sampled if (cur is not None
                                      and cur.trace_id == trace_id) else True
        else:
            rate = _SAMPLE_RATE.value
            sampled = rate >= 1.0 or random.random() <= rate
    return Span(kind=kind, service=service, method=method,
                trace_id=trace_id or random.getrandbits(63),
                span_id=next(_span_counter),
                parent_span_id=parent_span_id, start_us=now_us(),
                sampled=bool(sampled))


def child_span(kind: str, service: str = "", method: str = "") -> Span:
    """A span under the CURRENT span (trace, parentage and sampling
    inherited); a fresh root when no span is current."""
    if not _ENABLED.value:
        return NULL_SPAN
    tid, psid, smp = current_trace_ctx()
    return new_span(kind, service, method, trace_id=tid,
                    parent_span_id=psid, sampled=smp if tid else None)


def set_current_span(span: Span | None) -> None:
    _current_span.set(span)


def get_current_span() -> Span | None:
    return _current_span.get()


def current_trace_ctx() -> tuple[int, int, bool]:
    """(trace_id, parent_span_id, sampled): the trace context for
    callers that carry it across threads (the batcher queue, the decode
    slots, the supervisor's attempts), where the context variable does
    not follow."""
    s = get_current_span()
    if s is None or not s.trace_id:
        return 0, 0, True
    return s.trace_id, s.span_id, s.sampled


def _land(spans: list) -> None:
    """Append spans to the recent-span store, numbering them, and to the
    span database when one is set."""
    global _collect_seq
    with _collect_lock:
        for span in spans:
            _collect_seq += 1
            try:
                span.seq = _collect_seq
            except AttributeError:
                pass      # a foreign probe object on the native queue
        _collected.extend(spans)
    with _db_lock:
        if _db_dir is not None:
            for span in spans:
                try:
                    _db_append_locked(span)
                except (OSError, AttributeError):
                    pass  # disk trouble must never break collection


# ---- the on-disk span database: recordio-framed JSON segments with
# size rotation, written on the collector/drainer thread so the RPC
# path never touches disk ----
_db_lock = threading.Lock()
_db_dir: str | None = None
_db_writer = None
_db_file = None
_db_bytes = 0
_DB_ROTATE_BYTES = 16 << 20
_DB_KEEP_FILES = 4


def set_database_dir(path: str | None) -> None:
    """Persist spans under ``path`` (None or "": stop persisting); the
    ``rpcz_database_dir`` flag follows."""
    global _db_dir, _db_writer, _db_file, _db_bytes
    flags.set_flag("rpcz_database_dir", path or "", force=True)
    with _db_lock:
        if _db_file is not None:
            try:
                _db_file.close()
            except OSError:
                pass
        _db_writer = _db_file = None
        _db_bytes = 0
        _db_dir = path or None
        if _db_dir:
            os.makedirs(_db_dir, exist_ok=True)


def _db_append_locked(span: Span) -> None:
    global _db_writer, _db_file, _db_bytes
    if _db_writer is None or _db_bytes >= _DB_ROTATE_BYTES:
        if _db_file is not None:
            try:
                _db_file.close()
            except OSError:
                pass
        # prune BEFORE opening the new segment (a restart into a full
        # directory too): keep the newest KEEP-1, so KEEP files remain
        # with the one about to open
        segs = sorted(f for f in os.listdir(_db_dir)
                      if f.startswith("spans-"))
        for old in segs[:-(_DB_KEEP_FILES - 1)] if _DB_KEEP_FILES > 1 \
                else segs:
            try:
                os.unlink(os.path.join(_db_dir, old))
            except OSError:
                pass
        name = os.path.join(_db_dir, f"spans-{now_us()}.rio")
        _db_file = open(name, "ab")
        _db_writer = RecordWriter(_db_file)
        _db_bytes = 0
    rec = json.dumps(span_to_dict(span)).encode()
    _db_writer.write(rec)
    # no flush per span (a write(2) each would defeat the buffer): the
    # reader flushes the live segment first, and RecordReader resyncs
    # past a torn tail after a crash
    _db_bytes += len(rec) + 20


def load_disk_spans(limit: int = 200,
                    trace_id: int | None = None) -> list[Span]:
    """The persisted spans (of one trace when ``trace_id`` is given),
    oldest first, at most ``limit`` of the newest.  Newest segments are
    read first and the scan stops once ``limit`` spans are found."""
    with _db_lock:
        d = _db_dir
        if _db_writer is not None:
            try:
                _db_writer.flush()   # make the live segment readable
            except OSError:
                pass
    if not d or not os.path.isdir(d):
        return []
    out: list[Span] = []
    for name in sorted((f for f in os.listdir(d)
                        if f.startswith("spans-")), reverse=True):
        seg: list[Span] = []
        try:
            with open(os.path.join(d, name), "rb") as f:
                for _meta, body in RecordReader(f):
                    try:
                        rec = json.loads(body.decode())
                    except ValueError:
                        continue
                    if trace_id is not None and \
                            rec.get("trace_id") != trace_id:
                        continue
                    span = span_from_dict(rec)
                    if span is not None:
                        seg.append(span)
        except OSError:
            continue
        out = seg + out
        if len(out) >= limit:
            break
    return out[-limit:]


def span_to_dict(span: Span) -> dict:
    """One span as a JSON-able dict: the span database's record."""
    return {
        "trace_id": span.trace_id, "span_id": span.span_id,
        "parent_span_id": span.parent_span_id, "service": span.service,
        "method": span.method, "remote_side": span.remote_side,
        "start_us": span.start_us, "end_us": span.end_us,
        "request_size": span.request_size,
        "response_size": span.response_size,
        "error_code": span.error_code, "kind": span.kind,
        "recovered_from": span.recovered_from,
        "migrated_from": span.migrated_from,
        "annotations": list(span.annotations)}


def span_from_dict(rec: dict) -> Span | None:
    """The inverse of :func:`span_to_dict`; None for a malformed record
    (one bad record must not stop a read)."""
    try:
        rec = dict(rec)
        ann = [tuple(a) for a in rec.pop("annotations", ())]
        rec.pop("sampled", None)
        rec.pop("seq", None)
        return Span(annotations=ann, **rec)
    except (TypeError, ValueError, AttributeError):
        return None


class _SpanSample:
    """The collector path's sample: the store append runs on the
    collector thread."""

    __slots__ = ("span",)

    def __init__(self, span: Span):
        self.span = span

    def dump_and_destroy(self) -> None:
        _land([self.span])


# ---- the native span queue: the submit hot path is ONE lock-free push
# of the span object onto the port's native MPSC stack; the rate-limit
# grab and the store append run on the drainer thread ----
_spanq_mu = threading.Lock()
_spanq_thread: threading.Thread | None = None
# a safety-net bound only: the drainer is woken by submit and drains
# while the queue is nonempty
_SPANQ_PARK_S = 0.5
_spanq_wake = threading.Event()
# written by the drainer only: True while it is (about to be) parked,
# so submit pays one attribute read per span and an Event.set only on
# the empty -> nonempty transition
_spanq_parked = False
# exclusive access to the native queue for callers that need the
# drainer off it (tests pushing non-Span probes)
_spanq_pause = threading.Lock()
# set at interpreter exit: the drainer ends its loop
_spanq_stop = False


def _drain_native_spanq() -> None:
    """Move every natively queued span into the recent-span store,
    speed-limited (one budget grab per batch, earliest spans kept).
    Runs on the drainer and inside flush(); the native drain hands
    each span to exactly one caller."""
    fb = _lib.fastrpc      # None until the core loaded: nothing queued
    if fb is None:
        return
    spans = fb.spanq_drain()
    if not spans:
        return
    from .butil import hostcpu
    from .bvar.collector import get_or_create_limit
    t_cpu0 = time.thread_time()
    kept = spans[:get_or_create_limit("rpcz", 2000).grab_n(len(spans))]
    if kept:
        _land(kept)
    hostcpu.add("span_submit", (time.thread_time() - t_cpu0) * 1e6)


def _spanq_loop() -> None:
    """Drain while the native queue is nonempty, park when it runs dry.
    The drainer publishes ``_spanq_parked = True`` BEFORE its last
    pending check and submit pushes BEFORE reading the flag, so either
    the check sees the span or the submitter sees the flag and wakes
    the drainer: no wakeup is lost."""
    global _spanq_parked
    fb = _lib.fastrpc
    while not _spanq_stop:
        try:
            with _spanq_pause:
                _drain_native_spanq()
            if fb.spanq_pending():
                continue          # the queue refilled
            _spanq_parked = True
            try:
                if fb.spanq_pending():
                    continue      # raced a push
                _spanq_wake.wait(_SPANQ_PARK_S)
            finally:
                _spanq_parked = False
                _spanq_wake.clear()
        except Exception:
            time.sleep(0.05)      # a torn drain must not kill the drainer


def _ensure_spanq_drainer() -> None:
    global _spanq_thread
    with _spanq_mu:
        if _spanq_thread is None or not _spanq_thread.is_alive():
            if _spanq_thread is None:
                atexit.register(_stop_spanq_drainer)
            _spanq_thread = threading.Thread(
                target=_spanq_loop, daemon=True, name="rpcz-spanq")
            _spanq_thread.start()


def _stop_spanq_drainer() -> None:
    """At interpreter exit, end the drainer and join it.  The drainer
    records into the native flight recorder, so the core keeps per-thread
    state for it; a daemon thread torn down during finalization runs its
    native thread-exit hooks while the process's exit destroys the
    core's statics, and the process aborts on a corrupted heap."""
    global _spanq_stop
    _spanq_stop = True
    _spanq_wake.set()
    t = _spanq_thread
    if t is not None:
        t.join(2.0)


def submit(span: Span) -> None:
    if not _ENABLED.value or span is NULL_SPAN:
        return
    if not span.sampled:
        # decided at the trace root: dropping here keeps whole traces
        return
    span.end_us = span.end_us or now_us()
    from . import native_path
    fb = native_path.spanq()
    if fb is not None:
        fb.spanq_push(span)
        if _spanq_parked:
            _spanq_wake.set()
        t = _spanq_thread
        if t is None or not t.is_alive():
            _ensure_spanq_drainer()
        return
    from .bvar.collector import Collector, get_or_create_limit
    Collector.instance().submit(_SpanSample(span),
                                get_or_create_limit("rpcz", 2000),
                                family="rpcz")


def flush() -> None:
    """Land this thread's prior submissions in the recent-span store,
    from the native queue and the collector both."""
    with _spanq_pause:
        _drain_native_spanq()
    from .bvar.collector import Collector
    Collector.instance().flush(family="rpcz")


def recent_spans(limit: int = 100, trace_id: int | None = None) -> list[Span]:
    flush()
    with _collect_lock:
        spans = list(_collected)
    if trace_id is not None:
        spans = [s for s in spans if s.trace_id == trace_id]
    return spans[-limit:]


def spans_since(cursor: int, limit: int = 256,
                finished_only: bool = True) -> tuple[list[Span], int]:
    """Collected spans with ``seq > cursor`` (oldest first, at most
    ``limit``) and the store's high-water seq: re-pulling with the
    returned cursor sees each span once (spans the bounded store
    evicted meanwhile are skipped)."""
    flush()
    with _collect_lock:
        hi = _collect_seq
        out = [s for s in _collected if getattr(s, "seq", 0) > cursor]
    if finished_only:
        out = [s for s in out if s.end_us]
    out.sort(key=lambda s: s.seq)
    return out[:max(0, int(limit))], hi


def traceprintf(msg: str) -> None:
    """Annotate the current span."""
    s = get_current_span()
    if s is not None:
        s.annotate(msg)


# ---- timeline reconstruction: one trace as an indented, time-offset
# span tree ----

def trace_tree(spans: list[Span]) -> list[tuple[int, int, Span]]:
    """One trace's spans as a tree: ``[(depth, offset_us, span)]``,
    offsets from the trace's earliest start, children under their
    parent by start time.  A span whose parent was not collected
    surfaces as an extra root."""
    spans = sorted(spans, key=lambda s: (s.start_us, s.span_id))
    if not spans:
        return []
    by_id = {s.span_id: s for s in spans}
    children: dict[int, list[Span]] = {}
    roots: list[Span] = []
    for s in spans:
        p = s.parent_span_id
        if p and p in by_id and p != s.span_id:
            children.setdefault(p, []).append(s)
        else:
            roots.append(s)
    t0 = spans[0].start_us
    out: list[tuple[int, int, Span]] = []

    def walk(s: Span, depth: int) -> None:
        out.append((depth, s.start_us - t0, s))
        for c in children.get(s.span_id, ()):
            walk(c, depth + 1)

    for r in roots:
        walk(r, 0)
    return out


def format_trace(spans: list[Span], indent: str = "  ") -> str:
    """Human-readable timeline of ONE trace: tree-ordered spans with
    start offsets, latencies, recovery links and annotations."""
    tree = trace_tree(spans)
    if not tree:
        return "no spans\n"
    t0 = min(s.start_us for _, _, s in tree)
    total = max(s.end_us for _, _, s in tree) - t0
    lines = [f"trace {tree[0][2].trace_id} — {len(tree)} spans, "
             f"{total}us total"]
    for depth, off, s in tree:
        pad = indent * depth
        link = f" recovered_from=span {s.recovered_from}" \
            if s.recovered_from else ""
        if s.migrated_from:
            link += f" migrated_from=span {s.migrated_from}"
        err = f" err={s.error_code}" if s.error_code else ""
        lines.append(
            f"{pad}+{off}us [{s.kind}] {s.service}.{s.method} "
            f"span={s.span_id} {s.latency_us}us{err}{link}"
            + (f" peer={s.remote_side}" if s.remote_side else ""))
        for t, msg in s.annotations:
            lines.append(f"{pad}{indent}@+{max(0, t - t0)}us {msg}")
    return "\n".join(lines) + "\n"


def slowest_traces(spans: list[Span], n: int = 3) -> list[list[Span]]:
    """Group `spans` by trace; the n slowest traces by their root
    span's latency (the widest span when no root was collected),
    slowest first."""
    by_trace: dict[int, list[Span]] = {}
    for s in spans:
        by_trace.setdefault(s.trace_id, []).append(s)

    def root_latency(group: list[Span]) -> int:
        ids = {s.span_id for s in group}
        roots = [s for s in group
                 if not s.parent_span_id or s.parent_span_id not in ids]
        return max(s.latency_us for s in roots or group)

    ranked = sorted(by_trace.values(), key=root_latency, reverse=True)
    return ranked[:n]
