"""The port's native serving hot path, held against the JAX package's.

Counterparts of ``tests/test_native_hotpath.py`` on the port's own core
(``libbrpc_core_torch.so`` and its ``_fastrpc``):

  * ``TokenRing``: FIFO, bounded, a push never blocks; tokens before
    the terminal, the terminal exactly once (first wins, the Python
    error object with it); a pop parks until a push; the live-ring
    counter -- each scenario run on a port ring and a reference ring,
    with the same results;
  * the engine over native rings: streams, a wedged consumer cut while
    a fast reader streams on, the flag flipped mid-stream (in-flight
    rings drain natively, new requests take the Python ``_EmitBuf``),
    no ring leaked -- on a stand-in runner whose step is a token
    function (the reference tests' step functions);
  * ``batch_pad`` and ``page_table_fill`` equal to numpy and to the
    reference ``native_path`` on the same arrays;
  * the native span queue: FIFO, exactly once, under concurrent push
    and drain; rpcz over it; the drainer woken by submit; the port's
    spans land only in the port's queue;

and beyond those: greedy and speculative (NGram, draft_len 4) streams
of a port engine over ``TransformerRunner`` equal the reference
``DecodeEngine``'s over the same weights (``params_from_jax``), with the
flag on and off in both packages -- on, the engine hands each request a
native ring, pushes once per step through ``brpc_tokring_push_many``
and fills page tables natively; off, neither -- and a failed native
build raises.
"""
import ctypes
import gc
import threading
import time

import numpy as np
import pytest
import torch

from brpc_tpu import flags as ref_flags
from brpc_tpu import native_path as ref_np
from brpc_tpu import rpcz as ref_rpcz
from brpc_tpu.models import runner as R
from brpc_tpu.serving import DecodeEngine as RefEngine
from brpc_tpu.serving.speculative import NGramProposer as RefNGram
from brpc_tpu_torch import errors, flags, native_path, rpcz
from brpc_tpu_torch._core import build as core_build
from brpc_tpu_torch._core import lib as core_lib
from brpc_tpu_torch.kvcache import KVCacheStore
from brpc_tpu_torch.models import runner as T
from brpc_tpu_torch.serving import DecodeEngine, NGramProposer

from testutil import wait_until
from test_torch_runner import JCFG, JPARAMS, TCFG, _tparams

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _frozen_heap():
    """Every object alive before this module's tests goes to the
    collector's permanent generation, so each leak check's full
    collection scans what the tests made, not the whole JAX and torch
    heap.  A ring a test leaks is made after the freeze: still found."""
    gc.freeze()
    yield
    gc.unfreeze()


@pytest.fixture(autouse=True)
def native_flag():
    """The flag on in both packages, restored after; no port ring
    leaked by the test."""
    was = (flags.get_flag("native_hot_path_enabled"),
           ref_flags.get_flag("native_hot_path_enabled"))
    flags.set_flag("native_hot_path_enabled", True)
    ref_flags.set_flag("native_hot_path_enabled", True)
    base = _live()
    yield
    flags.set_flag("native_hot_path_enabled", was[0])
    ref_flags.set_flag("native_hot_path_enabled", was[1])
    assert wait_until(lambda: _live() == base, 10), \
        f"leaked {_live() - base} native emit rings"


def _live():
    gc.collect()
    return native_path.tokring_live()


def _set_flag(on: bool) -> None:
    flags.set_flag("native_hot_path_enabled", on)
    ref_flags.set_flag("native_hot_path_enabled", on)


class _Sink:
    def __init__(self):
        self.tokens: list = []
        self.done = threading.Event()
        self.err = "unset"

    def emit(self, tok):
        self.tokens.append(tok)

    def on_done(self, err):
        self.err = err
        self.done.set()


class _Counting:
    """Wraps a callable, counting calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a):
        self.calls += 1
        return self.fn(*a)


class StepRunner(T.ModelRunner):
    """A stand-in runner: the step is ``fn(tokens, positions)``, the K/V
    rows zeros (the reference tests drive their engine with such step
    functions)."""
    wants_pages = True
    name = "step_fn"

    def __init__(self, fn, kv_bytes_per_token):
        self.fn = fn
        self.kv_bytes_per_token = kv_bytes_per_token
        self.device = torch.device(CPU)

    def prefill(self, tokens, positions, pages, seq=None):
        pass

    def step(self, tokens, positions, pages):
        out = np.asarray(self.fn(tokens, positions), np.int32)
        return out, torch.zeros((len(tokens), self.kv_bytes_per_token),
                                dtype=torch.uint8)


class StepEngine:
    """A port DecodeEngine over a StepRunner and its own store."""

    def __init__(self, fn, name, *, num_slots=2, emit_buffer=256):
        self.store = KVCacheStore(device=CPU, page_bytes=64, page_tokens=4,
                                  max_blocks=4, name=f"{name}_kv")
        self.engine = DecodeEngine(
            runner=StepRunner(fn, self.store.pagepool.kv_bytes_per_token),
            store=self.store, num_slots=num_slots, emit_buffer=emit_buffer,
            device=CPU, name=name)

    def close(self):
        self.engine.close()
        self.store.clear()
        assert self.store.pagepool.blocks_leased() == 0


# ---------------------------------------------------------------------------
# TokenRing semantics, port beside reference
# ---------------------------------------------------------------------------

def _both(scenario):
    """Run `scenario(native_path, errors)` on the port and on the JAX
    package; the two results must be equal."""
    from brpc_tpu import errors as ref_errors
    got = scenario(native_path, errors)
    assert got == scenario(ref_np, ref_errors)
    return got


def test_tokring_fifo_bounded_and_nonblocking():
    def scenario(np_, _):
        ring = np_.token_ring(4)
        pushed = [ring.push(t) for t in (10, 11, 12, 13, 14)]
        size = len(ring)
        out = (ctypes.c_int32 * 8)()
        n, term, err = ring.pop_many(out, 0.0)
        return pushed, size, (n, term, err), [out[i] for i in range(n)]

    pushed, size, popped, toks = _both(scenario)
    assert pushed == [True] * 4 + [False], \
        "a push into a full ring must fail, not block"
    assert size == 4 and popped == (4, False, None)
    assert toks == [10, 11, 12, 13]


def test_tokring_tokens_flush_before_terminal():
    def scenario(np_, _):
        ring = np_.token_ring(8)
        ring.push(1)
        ring.push(2)
        ring.push_terminal(None)
        out = (ctypes.c_int32 * 1)()
        seen = []
        for _ in range(3):
            n, term, _ = ring.pop_many(out, 0.0)
            seen.append((n, term, out[0] if n else None))
        return seen

    # the terminal surfaces only once the ring is EMPTY
    assert _both(scenario) == [(1, False, 1), (1, True, 2), (0, True, None)]


def test_tokring_terminal_exactly_once_first_wins():
    def scenario(np_, errs):
        ring = np_.token_ring(8)
        first = errs.RpcError(errs.EOVERCROWDED, "cut")
        ring.push_terminal(first)
        ring.push_terminal(errs.RpcError(errs.ELOGOFF, "close"))
        out = (ctypes.c_int32 * 4)()
        n, term, err = ring.pop_many(out, 0.0)
        return n, term, err is first, err.code

    assert _both(scenario) == (0, True, True, errors.EOVERCROWDED)


def test_tokring_pop_wait_parks_until_push():
    def scenario(np_, _):
        ring = np_.token_ring(8)
        out = (ctypes.c_int32 * 4)()
        got = []
        t = threading.Thread(target=lambda: got.append(
            ring.pop_many(out, 5.0)))
        t.start()
        time.sleep(0.05)           # let it park in the native wait
        ring.push(42)
        t.join(10)
        assert not t.is_alive()
        return got[0][:2], out[0]

    assert _both(scenario) == ((1, False), 42)


def test_tokring_live_counter_tracks_rings():
    base, ref_base = _live(), ref_np.tokring_live()
    rings = [native_path.token_ring(4) for _ in range(5)]
    assert native_path.tokring_live() == base + 5
    # two cores in one process: the port's rings are not the reference's
    assert ref_np.tokring_live() == ref_base
    del rings
    assert _live() == base


# ---------------------------------------------------------------------------
# the engine over the native ring
# ---------------------------------------------------------------------------

def test_engine_uses_native_ring_and_streams_bit_exact():
    base = _live()
    srv = StepEngine(lambda t, p: t + 1, "t_tnh_native_engine")
    try:
        a = _Sink()
        srv.engine.submit([100], 8, a.emit, a.on_done)
        # the request's buffer is a native ring: the live count moved
        assert wait_until(lambda: native_path.tokring_live() > base, 10)
        assert a.done.wait(30) and a.err is None
        assert a.tokens == list(range(101, 109))
    finally:
        srv.close()


def _device_paced_step(t, p):
    """The next token after a 2 ms wait that releases the interpreter
    lock, as a device step does.  A step of no cost at all outruns any
    Python reader: a reader's emitter thread, woken by its ring, waits
    for the interpreter lock up to the 5 ms switch interval while such
    a loop pushes a token every ~0.5 ms, so an 8-token ring overflows
    and a reader that never stopped draining is cut with
    EOVERCROWDED."""
    time.sleep(0.002)
    return t + 1


def test_native_ring_wedged_consumer_cut_fast_reader_streams():
    """A consumer that stops draining its native ring is cut with
    EOVERCROWDED after its buffered tokens flush, while a fast reader
    beside it streams at full speed; the cut ring is freed."""
    base = _live()
    srv = StepEngine(_device_paced_step, "t_tnh_wedge", emit_buffer=8)
    try:
        slow, fast = _Sink(), _Sink()

        def slow_emit(tok):
            time.sleep(0.05)              # a wedged stream consumer
            slow.tokens.append(tok)

        srv.engine.submit([0], 10_000, slow_emit, slow.on_done)
        assert wait_until(lambda: native_path.tokring_live() > base, 10)
        assert wait_until(lambda: len(slow.tokens) >= 1, 20)
        t0 = time.monotonic()
        srv.engine.submit([500], 200, fast.emit, fast.on_done)
        assert fast.done.wait(20) and fast.err is None
        assert fast.tokens == list(range(501, 701))
        assert time.monotonic() - t0 < 5.0, \
            "the fast reader stalled behind the wedged one"
        assert slow.done.wait(30)
        assert slow.err is not None and slow.err.code == errors.EOVERCROWDED
        assert srv.engine.stats()["emit_cut"] == 1
        assert srv.engine.join_idle(10)
    finally:
        srv.close()


def test_python_fallback_bit_exact_and_flag_flip_safe(monkeypatch):
    """The flag off serves the identical stream through the Python
    _EmitBuf, and flipping it live only affects NEW requests."""
    rings = _Counting(core_lib.TokenRing)
    monkeypatch.setattr(core_lib, "TokenRing", rings)
    def run(native: bool):
        flags.set_flag("native_hot_path_enabled", native)
        srv = StepEngine(lambda t, p: (t * 3 + p) % 251,
                         f"t_tnh_flag_{int(native)}")
        try:
            s = _Sink()
            srv.engine.submit([7, 8, 9], 12, s.emit, s.on_done)
            assert s.done.wait(30) and s.err is None
            return list(s.tokens)
        finally:
            srv.close()

    assert run(True) == run(False), "the Python stream diverged"
    assert rings.calls == 1
    flags.set_flag("native_hot_path_enabled", True)
    srv = StepEngine(lambda t, p: t + 1, "t_tnh_flag_flip", num_slots=1)
    try:
        s = _Sink()
        srv.engine.submit([100], 40, s.emit, s.on_done)
        assert wait_until(lambda: len(s.tokens) >= 3, 20)
        flags.set_flag("native_hot_path_enabled", False)
        # the request admitted natively finishes natively
        assert s.done.wait(30) and s.err is None
        assert s.tokens == list(range(101, 141))
        # and a NEW request under the off flag takes the Python buffer
        s2 = _Sink()
        srv.engine.submit([200], 4, s2.emit, s2.on_done)
        assert s2.done.wait(30) and s2.err is None
        assert s2.tokens == list(range(201, 205))
        assert rings.calls == 2, \
            "a request under the off flag got a native ring"
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# batch pad and page-table fill
# ---------------------------------------------------------------------------

def test_batch_pad_matches_numpy_and_reference():
    rng = np.random.default_rng(9)
    for dtype in (np.float32, np.int32):
        rows = [np.ascontiguousarray(rng.integers(0, 100, n).astype(dtype))
                for n in (3, 7, 1, 16)]
        out = np.full((6, 16), 7, dtype=dtype)
        native_path.batch_pad(out, rows)
        ref = np.zeros((6, 16), dtype=dtype)
        for i, r in enumerate(rows):
            ref[i, : len(r)] = r
        np.testing.assert_array_equal(out, ref)
        theirs = np.full((6, 16), 7, dtype=dtype)
        ref_np.batch_pad(theirs, rows, [len(r) for r in rows])
        np.testing.assert_array_equal(out, theirs)


def test_page_table_fill_matches_numpy_and_reference():
    lists = [np.arange(5, dtype=np.int32),
             np.arange(100, 103, dtype=np.int32),
             np.empty(0, dtype=np.int32),
             np.arange(50, 62, dtype=np.int32)]   # truncated to width 8
    idx = [0, 2, 3, 5]
    table = np.zeros((6, 8), np.int32)
    native_path.page_table_fill(table, lists, idx)
    ref = np.full((6, 8), -1, np.int32)
    for k, i in enumerate(idx):
        ids = lists[k][:8]
        ref[i, : len(ids)] = ids
    np.testing.assert_array_equal(table, ref)
    theirs = np.zeros((6, 8), np.int32)
    ref_np.page_table_fill(theirs, lists, idx)
    np.testing.assert_array_equal(table, theirs)


# ---------------------------------------------------------------------------
# the native span queue
# ---------------------------------------------------------------------------

def test_spanq_drains_fifo_exactly_once():
    fb = native_path.spanq()
    assert fb is core_lib.fastrpc
    # the pause lock keeps the live drainer off the queue: it would
    # steal these non-Span probes
    with rpcz._spanq_pause:
        fb.spanq_drain()
        objs = [object() for _ in range(64)]
        for o in objs:
            fb.spanq_push(o)
        assert fb.spanq_pending() >= 64
        assert fb.spanq_drain() == objs, \
            "the drain lost, duplicated or reordered spans"
        assert fb.spanq_drain() == []
        assert fb.spanq_pending() == 0


def test_spanq_concurrent_push_drain_no_loss():
    fb = native_path.spanq()
    n, n_threads = 500, 4
    seen: list = []
    stop = threading.Event()

    def drainer():
        while not stop.is_set() or fb.spanq_pending() > 0:
            seen.extend(fb.spanq_drain())

    with rpcz._spanq_pause:
        fb.spanq_drain()
        dt = threading.Thread(target=drainer)
        dt.start()
        ts = [threading.Thread(target=lambda b=k * n: [
            fb.spanq_push(("span", b + i)) for i in range(n)])
            for k in range(n_threads)]
        [t.start() for t in ts]
        [t.join(30) for t in ts]
        stop.set()
        dt.join(30)
        assert not dt.is_alive()
    assert len(seen) == n * n_threads
    assert len(set(seen)) == n * n_threads, "a span was duplicated"
    for k in range(n_threads):       # per-producer FIFO
        mine = [s for s in seen if k * n <= s[1] < (k + 1) * n]
        assert mine == [("span", k * n + i) for i in range(n)]


def test_rpcz_submit_rides_the_port_queue_only():
    """With the flag on a port span goes through the port's own span
    queue -- never the reference's -- and flush lands it in the port's
    store; with it off, through the collector."""
    was = (rpcz.enabled(), rpcz.sample_rate())
    rpcz.set_enabled(True, 1.0)
    ref_fb = ref_np._fastrpc_mod()
    try:
        with rpcz._spanq_pause, ref_rpcz._spanq_pause:
            core_lib.fastrpc.spanq_drain()
            ref_fb.spanq_drain()
            sp = rpcz.new_span("client", "NativeQ", "Probe")
            rpcz.submit(sp)
            assert core_lib.fastrpc.spanq_pending() == 1
            assert ref_fb.spanq_pending() == 0
        rpcz.flush()
        assert any(s.span_id == sp.span_id for s in rpcz.recent_spans(200))
        assert not any(getattr(s, "span_id", 0) == sp.span_id
                       for s in ref_rpcz._collected)
        flags.set_flag("native_hot_path_enabled", False)
        off = rpcz.new_span("client", "NativeQ", "Off")
        with rpcz._spanq_pause:
            rpcz.submit(off)
            assert core_lib.fastrpc.spanq_pending() == 0
        assert any(s.span_id == off.span_id for s in rpcz.recent_spans(200))
    finally:
        rpcz.set_enabled(*was)


def test_spanq_event_wakeup_drains_well_under_a_poll_period():
    """The drainer is woken by submit: a span lands in the store in
    wakeup latency, observed passively (no flush).  A 50 ms poll would
    average ~25 ms; the bound is 10 ms."""
    was = (rpcz.enabled(), rpcz.sample_rate())
    rpcz.set_enabled(True, 1.0)

    def landed(span_id):
        with rpcz._collect_lock:
            return any(getattr(s, "span_id", 0) == span_id
                       for s in rpcz._collected)

    try:
        warm = rpcz.new_span("client", "SpanqWake", "Warm")
        rpcz.submit(warm)
        assert wait_until(lambda: landed(warm.span_id), 10)
        lats = []
        for i in range(10):
            time.sleep(0.004)     # let the drainer park again
            sp = rpcz.new_span("client", "SpanqWake", f"Probe{i}")
            t0 = time.monotonic()
            rpcz.submit(sp)
            assert wait_until(lambda: landed(sp.span_id), 5.0, 0.0005), \
                "a span never reached the store without a flush"
            lats.append(time.monotonic() - t0)
        avg = sum(lats) / len(lats)
        assert avg < 0.010, f"spanq drain averaged {avg * 1e3:.1f} ms"
    finally:
        rpcz.set_enabled(*was)


# ---------------------------------------------------------------------------
# real runners: the port's streams equal the reference's, flag on and off
# ---------------------------------------------------------------------------

# two prompts whose greedy streams at TransformerConfig() change token
# (most of this small model's streams repeat one token)
PROMPTS = ([12, 42, 55, 79, 61, 33, 20, 88, 94],
           [106, 107, 84, 0, 87, 28, 104, 116, 54])
NEW = 8


def _wave(engine, prompts):
    sinks = [_Sink() for _ in prompts]
    for p, s in zip(prompts, sinks):
        engine.submit(p, NEW, s.emit, s.on_done)
    for s in sinks:
        assert s.done.wait(60) and s.err is None, s.err
    return [s.tokens for s in sinks]


@pytest.mark.parametrize("draft", [None, "ngram"])
def test_streams_equal_reference_engine_flag_on_and_off(draft, monkeypatch):
    core_lib.load()
    push_many = _Counting(core_lib.core.brpc_tokring_push_many)
    monkeypatch.setattr(core_lib.core, "brpc_tokring_push_many", push_many)
    fill = _Counting(native_path.page_table_fill)
    monkeypatch.setattr(native_path, "page_table_fill", fill)
    name = f"t_tnh_streams_{draft}"
    store = T.make_store_for(TCFG, page_tokens=4, max_blocks=16, device=CPU,
                             name=name)
    kw = {} if draft is None else {"draft_len": 4}
    engine = DecodeEngine(
        runner=T.TransformerRunner(_tparams(), TCFG, store=store,
                                   device=CPU),
        store=store, num_slots=2, max_pages_per_slot=24,
        prefill_buckets=(8, 16), device=CPU, name=name,
        draft_runner=None if draft is None else NGramProposer(), **kw)
    rstore = R.make_store_for(JCFG, page_tokens=4, max_blocks=16,
                              name=f"{name}_ref_kv")
    ref_engine = RefEngine(
        runner=R.TransformerRunner(JPARAMS, JCFG, store=rstore),
        num_slots=2, store=rstore, max_pages_per_slot=24,
        prefill_buckets=(8, 16), name=f"{name}_ref",
        draft_runner=None if draft is None else RefNGram(), **kw)
    try:
        streams = {}
        for on in (True, False):
            _set_flag(on)
            steps0, pushes0, fills0 = (engine.stats()["steps"],
                                       push_many.calls, fill.calls)
            streams[on] = _wave(engine, PROMPTS)
            steps = engine.stats()["steps"] - steps0
            if on:
                # one native push per step, a verify's whole burst in it
                assert push_many.calls - pushes0 == steps > 0
                if draft is None:      # a verify builds its own tables
                    assert fill.calls - fills0 == steps
            else:
                assert push_many.calls == pushes0
                assert fill.calls == fills0
            assert _wave(ref_engine, PROMPTS) == streams[on], \
                f"flag {on}: the port's streams differ from the reference's"
        assert streams[True] == streams[False]
        if draft is not None:
            assert engine.stats()["speculative"]["spec_accepted"] > 0
    finally:
        engine.close()
        store.clear()
        ref_engine.close()
        rstore.clear()
        rstore.close()
        _set_flag(True)


def test_failed_native_build_raises(monkeypatch):
    """No quiet Python fallback: the native path raises when the core
    cannot build (only the flag chooses the Python paths)."""
    def broken():
        raise RuntimeError("native core build failed: (simulated)")

    monkeypatch.setattr(core_lib, "core", None)
    monkeypatch.setattr(core_lib, "fastrpc", None)
    monkeypatch.setattr(core_build, "build", broken)
    with pytest.raises(RuntimeError, match="build failed"):
        native_path.token_ring(4)
    with pytest.raises(RuntimeError, match="build failed"):
        native_path.page_table_fill(np.zeros((1, 1), np.int32), [], [])
    flags.set_flag("native_hot_path_enabled", False)
    assert native_path.token_ring(4) is None
